"""The plain PyTorch reference of DAIN and DAIN_slowmotion; imports nothing of the program."""
