"""The work of a training tick, counted from a configuration's
layer-shape table, and the published peaks it is held against.

The arithmetic of a stride-2 5×5 convolution and of the up-block is
frozen from the program's kernel microbench (``tools/bench_kernels.py``:
`half`, `s2_taps`, `up_taps`, `s2_ops` and the per-call byte counts), so
that a later change to the program cannot change the yardstick.  Rules:

* a product counts 2 operations and only where its tap lands inside the
  input map (SAME padding adds none); the up-block (nearest ×2 then 3×3)
  counts its four-tap parity form, 4n − 2 taps along an axis of n pixels;
* a backward counts its dx and its dw, each as many products as the
  forward; a pass entry of the table says how many of each a layer runs;
* each input byte is read once and each output byte written once (bf16
  activations and weights, f32 bias).

A table (``layers`` in a configuration's file) lists each network's layers
in order, with ``op`` one of ``linear``, ``conv``, ``conv5x5_s2``,
``upconv3x3`` and ``join``, the input map side ``hw``, ``cin``, ``cout``
and ``input``: ``hidden`` (the default; its dx is counted), ``image`` (the
network's image input: dx only in passes with ``dx_image``) or ``data``
(text or a frozen network's output: never a dx).  Under the name of a
driver's unit of work (``tick``) the configuration lists the passes one
unit runs: ``net``, ``batch``, ``fwd``, ``dx``, ``dw``, ``dx_image`` and
``repeat``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

PEAK_FLOPS = 989e12      # H100 SXM, dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
ESIZE = 2                # bf16


def half(n: int) -> int:
    """The output size of a SAME 5×5 stride-2 conv."""
    return (n + 1) // 2


def s2_taps(n: int) -> int:
    """(output, tap) pairs along one axis of a 5×5 stride-2 SAME conv over
    an n-long input whose tap lands inside the input."""
    no = half(n)
    lo = ((no - 1) * 2 + 5 - n) // 2
    return sum(1 for i in range(no) for k in range(5)
               if 0 <= 2 * i + k - lo < n)


def up_taps(n: int) -> int:
    """The same for the up-block over an n-long input: each of the 2n
    outputs sums two combined taps, less the one past each end."""
    return 4 * n - 2


def s2_ops(b, h, w, cin, co) -> int:
    return 2 * b * s2_taps(h) * s2_taps(w) * cin * co


def taps(n: int, k: int, stride: int, padding: str = "SAME") -> int:
    """(output, tap) pairs along one axis of a k-wide conv whose tap lands
    inside an n-long input."""
    if padding == "VALID":
        return (n - k + 1) * k
    no = -(-n // stride)
    lo = max((no - 1) * stride + k - n, 0) // 2
    return sum(1 for i in range(no) for t in range(k)
               if 0 <= stride * i + t - lo < n)


def layer_flops(layer: Dict, batch: int) -> int:
    """Operations of one forward of `layer` over `batch` examples."""
    op, b = layer["op"], batch
    cin, co = layer["cin"], layer["cout"]
    if op == "linear":
        return 2 * b * cin * co
    n = layer["hw"]
    if op == "conv":
        t = taps(n, layer["k"], layer["stride"], layer.get("padding", "SAME"))
        return 2 * b * t * t * cin * co
    if op == "conv5x5_s2":
        return s2_ops(b, n, n, cin, co)
    if op == "upconv3x3":
        return 2 * b * up_taps(n) ** 2 * cin * co
    if op == "join":
        return 2 * b * n * n * cin * co + 2 * b * layer["text"] * co
    raise ValueError(f"unknown op {op!r}")


def dense_flops(layer: Dict, batch: int) -> int:
    """Operations of `layer` as a dense library call computes them (every
    tap, pads included; the up-block as a 3×3 conv over the ×2 map, the
    join over the tiled text): what a FLOP counter reads from the plain
    reference."""
    op, b = layer["op"], batch
    cin, co = layer["cin"], layer["cout"]
    if op == "linear":
        return 2 * b * cin * co
    n = layer["hw"]
    if op in ("conv", "conv5x5_s2"):
        k = 5 if op == "conv5x5_s2" else layer["k"]
        s = 2 if op == "conv5x5_s2" else layer["stride"]
        no = (n - k + 1) if layer.get("padding") == "VALID" else -(-n // s)
        return 2 * b * no * no * k * k * cin * co
    if op == "upconv3x3":
        return 2 * b * 4 * n * n * 9 * cin * co
    if op == "join":
        return 2 * b * n * n * (cin + layer["text"]) * co
    raise ValueError(f"unknown op {op!r}")


def _runs(layer: Dict, p: Dict) -> Tuple[int, int, int]:
    """(forwards, dx, dw) of `layer` in pass `p`, before ``repeat``."""
    kind = layer.get("input", "hidden")
    dx = p.get("dx", 0)
    if kind == "data" or (kind == "image" and not p.get("dx_image", False)):
        dx = 0
    return p.get("fwd", 0), dx, p.get("dw", 0)


def work_flops(cfg: Dict, phase: str) -> int:
    """Operations of one unit of work (``phase``: "tick") of the
    configuration."""
    total = 0
    for p in cfg[phase]:
        for layer in cfg["layers"][p["net"]]:
            f, dx, dw = _runs(layer, p)
            total += (f + dx + dw) * p.get("repeat", 1) * layer_flops(
                layer, p["batch"])
    return total


def _upconv_bytes(kind: str, b: int, n: int, cin: int, co: int) -> int:
    x, y, w = b * n * n * cin, b * 4 * n * n * co, 9 * cin * co
    if kind == "fwd":
        return ESIZE * (x + w + y) + 4 * co
    return ESIZE * (x + y + w)         # dx: g, w → dx; dw: x, g → dw


def _conv5_bytes(kind: str, b: int, n: int, cin: int, co: int) -> int:
    x, y, w = b * n * n * cin, b * half(n) ** 2 * co, 25 * cin * co
    if kind == "fwd":
        return ESIZE * (x + w + y) + 4 * co
    return ESIZE * (x + y + w)


_FAMILY = {"upconv3x3": ("upconv3x3", _upconv_bytes),
           "conv5x5_s2": ("conv5x5_s2", _conv5_bytes)}


def family_calls(cfg: Dict, phase: str, family: str
                 ) -> List[Tuple[str, int, Dict]]:
    """(``fwd`` | ``dx`` | ``dw``, batch, layer) of every call of a
    kernel family's op in one unit of work."""
    op = _FAMILY[family][0]
    calls = []
    for p in cfg[phase]:
        for layer in cfg["layers"][p["net"]]:
            if layer["op"] != op:
                continue
            counts = dict(zip(("fwd", "dx", "dw"), _runs(layer, p)))
            for kind, k in counts.items():
                calls += [(kind, p["batch"], layer)] * (k * p.get("repeat", 1))
    return calls


def bound_s(nbytes: float, flops: float) -> float:
    """The least time of one call: the larger of its bytes over the
    memory rate and its operations over the bf16 rate."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS)


def family_least_s(cfg: Dict, phase: str, family: str) -> float:
    """The least time of all of a family's calls in one unit of work,
    each call bounded on its own."""
    size = _FAMILY[family][1]
    total = 0.0
    for kind, b, layer in family_calls(cfg, phase, family):
        n, cin, co = layer["hw"], layer["cin"], layer["cout"]
        total += bound_s(size(kind, b, n, cin, co), layer_flops(layer, b))
    return total


def net_dense_flops(layers: Iterable[Dict], batch: int) -> int:
    return sum(dense_flops(layer, batch) for layer in layers)
