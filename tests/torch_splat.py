"""K12 (``softmax_splat``) inputs as the SoftSplat cell makes them, and its
float64 yardstick, shared by the card-only tests and ``chip_smoke.py``."""
import torch

from vfidkr_torch.ops import softsplat as SS


def level_inputs(n, c, h, w, device, jump=False):
    """A level as the cell makes it: values in [0, 1), a smooth (5.3, -3.1)
    px move with a little noise, Z in [-6, 0]; ``jump`` moves the right
    part of each row (from mid-tile) 150 px right and 40 down, a box too
    large for shared memory in the tiles it cuts."""
    g = torch.Generator(device=device).manual_seed(h * w + c)
    x = torch.rand(n, c, h, w, generator=g, device=device)
    flow = torch.empty(n, 2, h, w, device=device)
    flow[:, 0], flow[:, 1] = 5.3, -3.1
    flow += (torch.rand(n, 2, h, w, generator=g, device=device) - 0.5) * 0.6
    if jump:
        flow[:, 0, :, w // 2 + 16:] += 150.0
        flow[:, 1, :, w // 2 + 16:] += 40.0
    z = -6.0 * torch.rand(n, 1, h, w, generator=g, device=device)
    return x, flow, z


def float64_splat(x, flow, z):
    """(the plain version in float64, each value's error scale): the scale
    is the float64 magnitude (the plain version on |x|) plus the value's
    own.  The float64 version lands where float32 lands (``x + fx`` rounded
    to float32), so a weight near 0 is the same small number in both."""
    n, _, h, w = x.shape
    grid = torch.stack(torch.meshgrid(
        torch.arange(w, device=x.device), torch.arange(h, device=x.device),
        indexing="xy"), 0).float()
    flow64 = (grid + flow).double() - grid.double()
    want = SS.softmax_splat_plain(x.double(), flow64, z.double())
    mag = SS.softmax_splat_plain(x.double().abs(), flow64, z.double())
    return want, mag + want.abs()
