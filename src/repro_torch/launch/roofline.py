"""Roofline accounting for the port on one NVIDIA H100.

The port's counterpart of ``repro.launch.roofline``, with the H100's rates
in place of the TPU v5e's (NVIDIA H100 SXM data sheet, dense rates, full
700 W power limit):

  device memory          3.35 TB/s (HBM3)
  bfloat16 on the        989 TFLOP/s (dense)
  tensor cores
  float32 outside the    67 TFLOP/s (an FMA counts as two operations)
  tensor cores
  simple int32           132 SMs x 64 INT32 lanes x 1.98 GHz boost
  NVLink                 900 GB/s a GPU, both directions together; one
                         direction (450 GB/s) is charged, as the reference
                         charges one ICI link

Beside the reference's ``cost_dict``, ``terms``, ``dominant`` and
``extrapolate``, this module holds the per-kernel work: for each CUDA
kernel of ``repro_torch.kernels``, the bytes that the function it computes
must move (each input byte read once, each output byte written once) and
the operations it does, from shapes alone (``*_work``), and the least time
the card could take for them (``bound*``: the larger of bytes over the
memory rate and operations over the rate of their type). ``chip_smoke.py``
reads its kernels' bound column from these functions, and
``Engine.lower(...).compile().cost_analysis()`` sums them over a route's
launches, so the two reckon alike. The ychg and ccl kernels do int32
operations, denoise float32.

For the LM cells: ``model_flops`` (6 N D for training, 2 N D for
inference, the useful-work floor) and ``collective_bytes``, the
reference's parser of an optimized HLO module's text (per-partition link
bytes by collective kind from each result shape and replica-group size,
with the same ring multipliers and float results counted at bfloat16
width). The port compiles no HLO, so its own dry run reckons collectives
from the sharding rules instead (``launch.dryrun.reckon_collectives``);
the parser is here for artifacts of the reference's dry run. LM cells
take the ``bfloat16`` rate. Their mesh keeps the reference's 16 x 16 (or
2 x 16 x 16) shape and charges one NVLink direction, which is optimistic:
a 16-wide "model" axis spans two 8-GPU NVLink domains, and a multi-pod
"pod" axis crosses the network between hosts.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS_PER_S = 989e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
LINK_BYTES_PER_S = 450e9
# operation type -> the card's rate for it
PEAK_OPS_PER_S = {"int32": PEAK_INT32_OPS_PER_S,
                  "float32": PEAK_FP32_OPS_PER_S,
                  "bfloat16": PEAK_BF16_OPS_PER_S}

OPS_PER_PIXEL = 3          # ychg: compare, and-not, add
# packed ychg: shift, a three-input logic op (b & ~(s | carry)), popcount,
# add, and the shift that takes the next byte's carry
PACKED_OPS_PER_BYTE = 5
PACK_OPS_PER_PIXEL = 3     # pack_rows: compare, shift, add
DIFF_OPS_PER_COLUMN = 5    # ychg_diff: subtract, compare, two max, negate
# ychg_diff's batch-entry instantiation: the same, the doubled cut vertex
# and the two sums of the totals
FINISH_OPS_PER_COLUMN = DIFF_OPS_PER_COLUMN + 3
# denoise: 8 + 7 adds, 8 squares, 1 FMA (2), 2 multiplies by 1/9, sqrt,
# subtract, abs, multiply by TAU, compare
DENOISE_FLOPS_PER_PIXEL = 32
# ccl: foreground test and store (init); two neighbour tests, index
# arithmetic and at least one find of two loads per link (merge); one find
# and store (flatten)
CCL_OPS_PER_PIXEL = 12

Work = Tuple[int, int]     # (bytes moved, operations)


def cost_dict(compiled) -> Dict[str, Any]:
    """``compiled.cost_analysis()`` as a dict, whether it returns a dict or
    a one-element list (as some JAX versions do): one shim, so that the dry
    run and the tests read either package's artifact alike."""
    cost = compiled.cost_analysis() or {}
    if isinstance(cost, list):
        cost = cost[0] if cost else {}
    return cost


# ------------------------------------------------------- per-kernel work


def fused_work(b: int, h: int, w: int, itemsize: int) -> Work:
    """``ychg_fused_full`` / ``ychg_fused_splith`` on a (B, H, W) stack:
    the stack read once; runs, births, deaths (int32), transitions (bool)
    a column and two int32 totals an image written once."""
    n = b * h * w
    return n * itemsize + b * w * (3 * 4 + 1) + b * 2 * 4, OPS_PER_PIXEL * n


def colscan_work(h: int, w: int, itemsize: int) -> Work:
    """Step 1 on one (H, W) mask: the mask read once, 4 B a column of int32
    runs written."""
    return h * w * itemsize + w * 4, OPS_PER_PIXEL * h * w


def diff_work(w: int) -> Work:
    """Step 2 (``ychg_diff``): (W,) int32 runs read once, a bool and two
    int32 a column written."""
    return w * 4 + w * (1 + 4 + 4), DIFF_OPS_PER_COLUMN * w


def finish_work(w: int) -> Work:
    """The batch entry's step-2 kernel on one mask's (W,) runs: the runs
    read once; cut vertices, births and deaths (int32), transitions (bool)
    and the two int32 totals written once."""
    return w * 4 + w * (4 + 1 + 4 + 4) + 2 * 4, FINISH_OPS_PER_COLUMN * w


def denoise_work(n: int, itemsize: int) -> Work:
    """denoise on n pixels: input read once, 4 B a pixel of float32
    written; float32 operations."""
    return n * (itemsize + 4), DENOISE_FLOPS_PER_PIXEL * n


def ccl_work(n: int, itemsize: int) -> Work:
    """ccl on n pixels: input read once, 4 B a pixel of int32 labels
    written."""
    return n * (itemsize + 4), CCL_OPS_PER_PIXEL * n


def packed_colscan_work(hp: int, w: int) -> Work:
    """The packed scan on one (ceil(H/8), W) uint8 mask: each packed byte
    read once, 4 B a column of int32 runs written."""
    return hp * w + w * 4, PACKED_OPS_PER_BYTE * hp * w


def packed_fused_work(hp: int, w: int) -> Work:
    """The packed fused kernel: runs, cut vertices, births and deaths
    (int32) and transitions (bool) a column, two int32 totals."""
    return hp * w + w * (4 * 4 + 1) + 2 * 4, PACKED_OPS_PER_BYTE * hp * w


def pack_rows_work(h: int, w: int, itemsize: int) -> Work:
    """``pack_rows``: the (H, W) mask read once, its (ceil(H/8), W) uint8
    packing written once."""
    return h * w * itemsize + -(-h // 8) * w, PACK_OPS_PER_PIXEL * h * w


# ---------------------------------------------------------- least times


def bound_ms(nbytes: float, ops: float, operation: str = "int32"
             ) -> Tuple[float, str]:
    """The least time (ms) the card needs to move ``nbytes`` and do ``ops``
    operations of type ``operation``, and which of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[operation]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _bound(work: Work, operation: str = "int32") -> Tuple[float, str, int]:
    nbytes, ops = work
    return (*bound_ms(nbytes, ops, operation), int(nbytes))


def bound(x) -> Tuple[float, str, int]:
    """Least time (ms) the fused yCHG kernels need for one call on ``x``
    (B, H, W), what bounds it, and the byte count."""
    b, h, w = x.shape
    return _bound(fused_work(b, h, w, x.element_size()))


def bound_colscan(x) -> Tuple[float, str, int]:
    """The same for step 1 on one (H, W) mask."""
    w = x.shape[-1]
    return _bound(colscan_work(x.numel() // max(w, 1), w, x.element_size()))


def bound_diff(runs) -> Tuple[float, str, int]:
    """The same for step 2 on (W,) int32 runs."""
    return _bound(diff_work(runs.shape[0]))


def bound_finish(runs) -> Tuple[float, str, int]:
    """The same for the batch entry's step-2 kernel on one mask's runs."""
    return _bound(finish_work(runs.shape[-1]))


def bound_denoise(x) -> Tuple[float, str, int]:
    """The same for denoise, against its float32 work."""
    return _bound(denoise_work(x.numel(), x.element_size()), "float32")


def bound_ccl(x) -> Tuple[float, str, int]:
    """The same for ccl."""
    return _bound(ccl_work(x.numel(), x.element_size()))


def bound_packed_colscan(p) -> Tuple[float, str, int]:
    """The same for the packed scan on one (ceil(H/8), W) uint8 mask."""
    return _bound(packed_colscan_work(*p.shape))


def bound_packed_fused(p) -> Tuple[float, str, int]:
    """The same for the packed fused kernel."""
    return _bound(packed_fused_work(*p.shape))


def bound_pack_rows(x) -> Tuple[float, str, int]:
    """The same for ``pack_rows`` on an (H, W) mask."""
    return _bound(pack_rows_work(*x.shape, x.element_size()))


# ------------------------------------------------- the reference's terms


def extrapolate(m1: Dict[str, float], m2: Dict[str, float], g: int
                ) -> Dict[str, float]:
    """Linear trip-count correction from G=1 / G=2 unrolled probes."""
    out = {}
    for k in m1:
        per_group = m2.get(k, 0.0) - m1.get(k, 0.0)
        base = m1.get(k, 0.0) - per_group
        out[k] = base + g * per_group
    return out


def terms(*, flops_global: float, bytes_global: float,
          coll_bytes_per_partition: float = 0.0, n_partitions: int = 1,
          operation: str = "int32") -> Dict[str, float]:
    """The three roofline times of a cell over ``n_partitions`` cards:
    operations of type ``operation`` over the card's rate for them, bytes
    over its memory rate, collective bytes over one NVLink direction."""
    chips = n_partitions
    cg = coll_bytes_per_partition * n_partitions
    return {
        "flops_global": flops_global,
        "bytes_global": bytes_global,
        "coll_bytes_global": cg,
        "compute_s": flops_global / (chips * PEAK_OPS_PER_S[operation]),
        "memory_s": bytes_global / (chips * PEAK_BYTES_PER_S),
        "collective_s": cg / (chips * LINK_BYTES_PER_S),
    }


def dominant(t: Dict[str, float]) -> str:
    vals = {k: t[k] for k in ("compute_s", "memory_s", "collective_s")}
    return max(vals, key=vals.get)



def model_flops(cfg, shape) -> float:
    """6*N_eff*D (train) / 2*N_eff*D (prefill/decode): the useful-work floor.

    N_eff = active params minus the embedding lookup table when untied
    (lookup is a gather, not a matmul; a tied table doubles as the lm_head
    matmul so it stays).
    """
    from repro_torch.models import active_params

    n = active_params(cfg)
    if not cfg.tie_embeddings:
        n -= cfg.vocab_size * cfg.d_model
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token


# ------------------------------------------- the reference's HLO parser

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}
_FLOAT_TYPES = {"f16", "bf16", "f32", "f64"}

COLL_TYPES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# `%name = TYPE[dims]{layout} op-name(...`  (also tuple-result async starts)
_INSTR_RE = re.compile(
    r"=\s*(?:\(?)\s*([a-z0-9]+)\[([0-9,]*)\][^=]*?\s"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\("
)
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_LIST_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return default


def ring_bytes(op: str, result_bytes: float, g: int) -> float:
    """Per-partition link bytes of one collective whose result holds
    ``result_bytes``, over a group of ``g``, by the ring algorithms:
    all-gather and all-to-all result x (g-1)/g, all-reduce result x
    2(g-1)/g (reduce-scatter + all-gather), reduce-scatter result x (g-1)
    (its operand is result x g), collective-permute result x 1."""
    if op in ("all-gather", "all-to-all"):
        return result_bytes * (g - 1) / g
    if op == "all-reduce":
        return result_bytes * 2 * (g - 1) / g
    if op == "reduce-scatter":
        return result_bytes * (g - 1)
    return result_bytes


def collective_bytes(hlo_text: str, *, clamp_float_to_bf16: bool = True,
                     default_group: int = 16) -> Dict[str, float]:
    """Per-partition link traffic (bytes) by collective type, + op counts,
    from an optimized HLO module's text."""
    out: Dict[str, float] = {t: 0.0 for t in COLL_TYPES}
    counts: Dict[str, int] = {t: 0 for t in COLL_TYPES}
    for line in hlo_text.splitlines():
        m = _INSTR_RE.search(line)
        if not m:
            continue
        dtype, dims, op = m.group(1), m.group(2), m.group(3)
        if dtype not in _DTYPE_BYTES:
            continue
        if f"{op}-done" in line:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        width = _DTYPE_BYTES[dtype]
        if clamp_float_to_bf16 and dtype in _FLOAT_TYPES:
            width = min(width, 2)
        out[op] += ring_bytes(op, n * width, _group_size(line, default_group))
        counts[op] += 1
    out["total"] = sum(out[t] for t in COLL_TYPES)
    for t in COLL_TYPES:
        out["_count_" + t] = counts[t]
    return out
