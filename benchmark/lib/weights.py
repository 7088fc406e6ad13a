"""A configuration's weights, made on the device from the seed.

Every floating-point tensor of the state dict is drawn from one normal and
one uniform draw of a ``torch.Generator`` on the device (two large calls),
then cut into the tensors: a conv weight is normal with the standard
deviation of its child's initialisation in the configuration file
(``init``: xavier, kaiming, msra or lecun, as the source networks
initialise them), a bias is 0, a BatchNorm scale 1 and its running
statistics 0 and 1.  Then ``tame``: every parameter times ``scale`` and
every bias jittered by ``U(-jitter, jitter)``, so activations stay sane
through the deep graph and the flows are not trivial; ``bias_add`` adds a
fixed vector (the flow head's (5.3, -3.1) px move, at 1/20 of a pixel and
halved by the 4x upsample's ``20 t``).  The same seed gives the same
tensors.  The program's model is built on the meta device, its tensors
allocated on the card and filled with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import math

import torch

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one of the run's streams of draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) & SEED_MASK)
    return g


def _rule(name: str, init: list) -> str:
    for prefix, rule in init:
        if name.startswith(prefix):
            return rule
    raise KeyError(f"no init rule for {name}")


def _std(shape, rule: str, transposed: bool) -> float:
    k2 = math.prod(shape[2:])
    cout, cin = (shape[1], shape[0]) if transposed else (shape[0], shape[1])
    fan_in, fan_out = cin * k2, cout * k2
    return {"xavier": math.sqrt(2.0 / (fan_in + fan_out)),
            "kaiming": math.sqrt(2.0 / fan_in),
            "msra": math.sqrt(2.0 / fan_out),
            "lecun": math.sqrt(1.0 / fan_in)}[rule]


def _mul(name: str, tame: dict) -> float:
    return math.prod(f for prefix, f in tame.get("scale_mul", {}).items()
                     if name.startswith(prefix))


def make_state(shapes: dict, config: dict, seed: int, device) -> dict:
    """name -> tensor on ``device`` for every entry of ``shapes`` (name ->
    (shape, dtype)), drawn from ``seed`` as the module docstring says."""
    init, tame = config["init"], config["tame"]
    transposed = tuple(config.get("transposed", ()))
    floats = [(n, s) for n, (s, dt) in shapes.items() if dt.is_floating_point]
    total = sum(math.prod(s) for _, s in floats)
    g = generator(seed, device, stream=1)
    normal = torch.randn(total, generator=g, device=device)
    jitter = torch.rand(total, generator=g, device=device)
    state, pos = {}, 0
    with torch.no_grad():
        for name, shape in floats:
            n = math.prod(shape)
            z, u = normal[pos:pos + n].view(shape), jitter[pos:pos + n].view(shape)
            pos += n
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "running_mean":
                t = torch.zeros(shape, device=device)
            elif leaf == "running_var":
                t = torch.ones(shape, device=device)
            elif leaf == "weight" and len(shape) > 1:
                t = z * (_std(shape, _rule(name, init), name.startswith(
                    transposed)) * tame["scale"] * _mul(name, tame))
            elif leaf == "weight":                     # a BatchNorm scale
                t = torch.full(shape, tame["scale"], device=device)
            else:                                      # a bias
                t = (u - 0.5) * (2.0 * tame["jitter"])
            state[name] = t.contiguous()
        for name, vec in config.get("bias_add", {}).items():
            state[name] += torch.tensor(vec, device=device)
    for name, (shape, dt) in shapes.items():
        if not dt.is_floating_point:
            state[name] = torch.zeros(shape, dtype=dt, device=device)
    return state


def shapes_of(module: torch.nn.Module) -> dict:
    """name -> (shape, dtype) of a module's state dict (a meta module)."""
    return {k: (tuple(v.shape), v.dtype)
            for k, v in module.state_dict().items()}
