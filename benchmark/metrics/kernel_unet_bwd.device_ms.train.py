"""Device time a step of the kernel U-Net's and its two heads' backward
(``models/mononet.py``): the program's ``vfidkr/kernel_unet/backward``
spans, each with the gradient sums of its node's evaluation."""

LAYER = "loss + backward"
UNIT = "ms/step"
MOVES = "train_step_ms"


def read(t):
    from benchmark.lib.spans import backward_ms
    return backward_ms(t, "vfidkr/kernel_unet/backward")
