"""Parity: the port's CCL (plain version, canonicalization, CPU wrapper)
against the JAX package's ``labels`` (jnp reference) and ``labels_pallas``
(Pallas kernel in interpret mode), and against a pure-Python BFS oracle,
on the same seeded numpy masks; and a NumPy model of the CUDA kernel's
algorithm (``csrc/ccl.cu``: tile-local union-find, seam links, per-tile
rewrite) against the TPU kernel's fixpoint and the plain version, since
the kernel itself runs only on the card. Tolerance: exact, dtypes
included.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repro.kernels import ccl as jccl  # noqa: E402
from repro_torch.kernels import ccl  # noqa: E402

RAGGED = [(1, 1), (1, 7), (6, 1), (17, 23), (20, 17), (33, 64)]


def _random(shape, seed, density=0.5):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < density).astype(np.uint8)


def _checkerboard(h, w):
    return (np.indices((h, w)).sum(axis=0) % 2).astype(np.uint8)


def _serpentine(h, w):
    """One component snaking through every other row: the longest chain a
    (h, w) mask can hold for its area."""
    m = np.zeros((h, w), np.uint8)
    m[::2] = 1
    for r in range(1, h, 2):
        m[r, w - 1 if (r // 2) % 2 == 0 else 0] = 1
    return m


def _bfs(mask):
    """4-neighbour BFS: canonical labels (row-major first encounter), the
    raw fixpoint (min linear index + 1 per component) and the count."""
    h, w = mask.shape
    canon = np.zeros((h, w), np.int32)
    raw = np.zeros((h, w), np.int32)
    n = 0
    for i in range(h):
        for j in range(w):
            if mask[i, j] and not canon[i, j]:
                n += 1
                root = i * w + j + 1
                stack = [(i, j)]
                canon[i, j], raw[i, j] = n, root
                while stack:
                    y, x = stack.pop()
                    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                        yy, xx = y + dy, x + dx
                        if (0 <= yy < h and 0 <= xx < w and mask[yy, xx]
                                and not canon[yy, xx]):
                            canon[yy, xx], raw[yy, xx] = n, root
                            stack.append((yy, xx))
    return canon, raw, n


CASES = ([(f"random {s}", _random((2, *s), sum(s))) for s in RAGGED] + [
    ("all-zero", np.zeros((2, 9, 13), np.uint8)),
    ("all-one", np.ones((2, 9, 13), np.uint8)),
    ("checkerboard", np.stack([_checkerboard(10, 15),
                               1 - _checkerboard(10, 15)])),
    ("serpentine", np.stack([_serpentine(21, 17), _serpentine(17, 21).T])),
    ("dense", _random((2, 24, 31), 3, density=0.7)),
])
IDS = [c[0] for c in CASES]


def assert_summary_equal(got, want):
    for f in ccl.CCL_FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype == np.int32, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("jax_fn", ["labels", "labels_pallas"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_labels_match_jax(case, jax_fn):
    _, x = case
    want = getattr(jccl, jax_fn)(jnp.asarray(x))
    assert_summary_equal(ccl.labels(torch.from_numpy(x)), want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fixpoint_and_labels_match_bfs_oracle(case):
    _, x = case
    raw = ccl.ccl_fixpoint_plain(torch.from_numpy(x))
    assert raw.dtype == torch.int32
    got = ccl.labels(torch.from_numpy(x))
    for b in range(x.shape[0]):
        canon, want_raw, n = _bfs(x[b])
        np.testing.assert_array_equal(raw[b].numpy(), want_raw)
        np.testing.assert_array_equal(got.labels[b].numpy(), canon)
        assert int(got.n_components[b]) == n


@pytest.mark.parametrize("dtype", [np.uint8, np.bool_, np.int32, np.float32,
                                   np.int16])
def test_input_dtypes(dtype):
    x = _random((2, 17, 23), 7).astype(dtype)
    want = jccl.labels(jnp.asarray(x))
    assert_summary_equal(ccl.labels(torch.from_numpy(x)), want)


def test_canonicalize_matches_jax():
    """The same raw fixpoint through both packages' ``_canonicalize``."""
    x = _random((3, 19, 26), 9)
    raw = ccl.ccl_fixpoint_plain(torch.from_numpy(x))
    got = ccl._canonicalize(raw, torch.from_numpy(x) != 0)
    want = jccl._canonicalize(jnp.asarray(raw.numpy()), jnp.asarray(x) != 0)
    assert_summary_equal(got, want)


def test_seed_and_neighbor_min_match_jax():
    x = _random((2, 7, 9), 4)
    seed = ccl._seed_labels(torch.from_numpy(x) != 0)
    np.testing.assert_array_equal(
        seed.numpy(), np.asarray(jccl._seed_labels(jnp.asarray(x) != 0)))
    np.testing.assert_array_equal(
        ccl._neighbor_min(seed).numpy(),
        np.asarray(jccl._neighbor_min(jnp.asarray(seed.numpy()))))


def test_serpentine_converges_in_few_sweeps():
    """Hooking plus full pointer jumping: a serpentine whose chain is
    hundreds of pixels long settles in a handful of sweeps."""
    x = torch.from_numpy(_serpentine(61, 47))[None]
    raw, sweeps = ccl.fixpoint_with_sweeps(x)
    assert sweeps <= 8
    assert torch.all(raw[x != 0] == 1) and torch.all(raw[x == 0] == 0)


def test_wrapper_on_cpu_runs_the_plain_version():
    x = torch.from_numpy(_random((3, 19, 40), 1))
    before = ccl.LAUNCHES["ccl"]
    assert torch.equal(ccl.ccl_fixpoint(x), ccl.ccl_fixpoint_plain(x))
    assert_summary_equal(ccl.labels_kernel(x), ccl.labels(x))
    assert ccl.LAUNCHES["ccl"] == before   # no kernel launched


def test_wrapper_refuses_other_devices_shapes_and_sizes():
    with pytest.raises(ValueError, match="CUDA tensor"):
        ccl.ccl_fixpoint(torch.zeros((1, 4, 4), device="meta"))
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        ccl.ccl_fixpoint(torch.zeros((4, 4)))
    with pytest.raises(ValueError, match="sentinel"):
        ccl.ccl_fixpoint_plain(torch.zeros((1, 1 << 15, 1 << 15),
                                           device="meta"))


def test_empty_stacks():
    for shape in [(0, 4, 4), (2, 0, 5), (2, 5, 0)]:
        s = ccl.labels(torch.zeros(shape, dtype=torch.uint8))
        want = jccl.labels(jnp.zeros(shape, jnp.uint8))
        assert tuple(s.labels.shape) == shape
        assert_summary_equal(s, want)


def test_pad_invariance():
    """Zero padding to a larger canvas starts no component and never
    renumbers the native region."""
    mask = _random((1, 13, 19), 5)
    padded = np.zeros((1, 20, 32), np.uint8)
    padded[0, :13, :19] = mask[0]
    base = ccl.labels(torch.from_numpy(mask))
    pad = ccl.labels(torch.from_numpy(padded))
    assert torch.equal(pad.labels[0, :13, :19], base.labels[0])
    assert torch.all(pad.labels[0, 13:] == 0)
    assert torch.all(pad.labels[0, :, 19:] == 0)
    assert torch.equal(pad.n_components, base.n_components)


# ------------------------------------------------------------------------
# The CUDA kernel's design (csrc/ccl.cu), modelled in NumPy: the card alone
# runs the kernel, so these tests hold its algorithm (tile-local union-find
# over segment runs, border entries, seam links with the 2 x 2 skips, the
# per-tile rewrite) against the reference's fixpoint on the CPU.

CSRC = Path(ccl.__file__).resolve().parent / "csrc" / "ccl.cu"
_CONSTS = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);",
                                            CSRC.read_text())}
# the kernel's tile and the pixels of a tile row one thread owns
KERNEL_TILE = (_CONSTS["kTileH"], _CONSTS["kTileW"], _CONSTS["kSeg"])
_UNSET = -7  # a labels entry the model's pass 1 has not written


def _tile_forest(fg, r0, c0, tile, rng):
    """Pass 1's shared forest of the tile at (r0, c0): the run starts of
    its segments as nodes, linked as the kernel links them (in a shuffled
    order, the threads' order being arbitrary). Returns the tile's mask,
    each pixel's run start (tile-local), and a find."""
    th, tw, seg = tile
    h, w = fg.shape
    rh, rw = min(th, h - r0), min(tw, w - c0)
    t = np.zeros((th, tw), bool)
    t[:rh, :rw] = fg[r0:r0 + rh, c0:c0 + rw]
    start = np.full((th, tw), -1)
    parent = {}
    for lr in range(th):
        for s0 in range(0, tw, seg):
            st = -1
            for lc in range(s0, s0 + seg):
                if not t[lr, lc]:
                    st = -1
                    continue
                if st < 0:
                    st = parent.setdefault(lr * tw + lc, lr * tw + lc)
                start[lr, lc] = st

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    links = []
    for lr in range(th):
        for s0 in range(0, tw, seg):
            if s0 and t[lr, s0] and t[lr, s0 - 1]:
                links.append((start[lr, s0], start[lr, s0 - 1]))
            for lc in range(s0, s0 + seg):
                if lr and t[lr, lc] and t[lr - 1, lc] and not (
                        lc and t[lr, lc - 1] and t[lr - 1, lc - 1]):
                    links.append((start[lr, lc], start[lr - 1, lc]))
    rng.shuffle(links)
    for a, b in links:
        a, b = find(a), find(b)
        parent[max(a, b)] = min(a, b)
    border = np.zeros((th, tw), bool)
    border[[0, rh - 1], :rw] = True
    border[:rh, [0, rw - 1]] = True
    return t, start, find, border


def _model_fixpoint(mask, tile, seed=0):
    """The kernel's three passes on one (H, W) mask, in NumPy; every read of
    the global forest is checked to hit an entry pass 1 wrote."""
    th, tw, _ = tile
    rng = np.random.default_rng(seed)
    fg = mask != 0
    h, w = fg.shape
    lab = np.full(h * w, _UNSET, np.int64)
    tiles = [(r0, c0) for r0 in range(0, h, th) for c0 in range(0, w, tw)]

    def gidx(r0, c0, k):
        return (r0 + k // tw) * w + c0 + k % tw

    def read(x):  # the entry of 1-based label x
        v = lab[x - 1]
        assert v > 0, f"read of entry {x - 1}: {v}"
        return int(v)

    def gfind(x):  # path halving, as find_root
        while (p := read(x)) != x:
            if (gp := read(p)) == p:
                return p
            lab[x - 1] = min(lab[x - 1], gp)
            x = gp
        return x

    for r0, c0 in tiles:  # pass 1
        t, start, find, border = _tile_forest(fg, r0, c0, tile, rng)
        for lr, lc in zip(*np.nonzero(border)):
            g = (r0 + lr) * w + c0 + lc
            if not t[lr, lc]:
                lab[g] = 0
                continue
            root = gidx(r0, c0, find(start[lr, lc])) + 1
            lab[g] = lab[root - 1] = root
    pairs = []  # pass 2
    for r0 in range(th, h, th):
        for c in range(w):
            p = r0 * w + c
            if not (c and lab[p - 1] and lab[p - w - 1]):
                pairs.append((p, p - w))
    for c0 in range(tw, w, tw):
        for r in range(h):
            p = r * w + c0
            if not (r % th and lab[p - w] and lab[p - w - 1]):
                pairs.append((p, p - 1))
    rng.shuffle(pairs)
    for p, q in pairs:
        a, b = int(lab[p]), int(lab[q])
        assert _UNSET not in (a, b)
        if not (a and b):
            continue
        while True:  # unite
            a, b = gfind(a), gfind(b)
            if a == b:
                break
            a, b = max(a, b), min(a, b)
            old = int(lab[a - 1])
            lab[a - 1] = min(old, b)
            if old == a:
                break
            a = old
    rng.shuffle(tiles)  # pass 3, the tiles in any order
    for r0, c0 in tiles:
        t, start, find, border = _tile_forest(fg, r0, c0, tile, rng)
        flagged = {find(start[p]) for p in zip(*np.nonzero(border & t))}
        final = {}
        for lr, lc in zip(*np.nonzero(t)):
            root = find(start[lr, lc])
            if root not in final:
                g = gidx(r0, c0, root) + 1
                final[root] = gfind(g) if root in flagged else g
        rh, rw = min(th, h - r0), min(tw, w - c0)
        for lr in range(rh):
            for lc in range(rw):
                lab[(r0 + lr) * w + c0 + lc] = (
                    final[find(start[lr, lc])] if t[lr, lc] else 0)
    return lab.reshape(h, w).astype(np.int32)


def _pallas_fixpoint(x):
    """The TPU kernel's raw fixpoint, in interpret mode as the JAX tests
    run it."""
    b, h, w = x.shape
    spec = pl.BlockSpec((1, h, w), lambda i: (i, 0, 0))
    return np.asarray(pl.pallas_call(
        jccl._ccl_kernel, grid=(b,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((b, h, w), jnp.int32),
        interpret=True)(jnp.asarray(x)))


def _corner_component(h, w):
    """A component whose minimum lies in the last tile: a hook that starts
    at the top of the bottom-right tile and runs down and then left into
    the bottom-left tile, beside random specks."""
    m = _random((h, w), 31, density=0.05)
    th, tw, _ = KERNEL_TILE
    r, c = (h - 1) // th * th, (w - 1) // tw * tw + 3
    m[r - 1:, :] = 0
    m[r:h, c] = 1
    m[h - 1, 1:c + 1] = 1
    return m


MODEL_CASES = [
    ("random 70 x 300", _random((70, 300), 41)),
    ("dense 70 x 300", _random((70, 300), 42, density=0.75)),
    ("sparse 70 x 300", _random((70, 300), 43, density=0.3)),
    ("serpentine 97 x 390", _serpentine(97, 390)),
    ("serpentine 390 x 97, transposed",
     np.ascontiguousarray(_serpentine(97, 390).T)),
    ("all-one 65 x 257", np.ones((65, 257), np.uint8)),
    ("checkerboard 33 x 129", _checkerboard(33, 129)),
    ("ragged 33 x 129", _random((33, 129), 44, density=0.6)),
    ("ragged 31 x 127", _random((31, 127), 45, density=0.6)),
    ("minimum in the last tile", _corner_component(70, 300)),
]
MODEL_IDS = [c[0] for c in MODEL_CASES]


def test_model_reads_the_kernels_tile():
    """The model runs at the tile csrc/ccl.cu declares, whose segments
    divide its width, as the model assumes."""
    th, tw, seg = KERNEL_TILE
    assert (th, tw, seg) == (32, 128, 16)
    assert tw % seg == 0


@pytest.mark.parametrize("case", MODEL_CASES, ids=MODEL_IDS)
def test_kernel_model_matches_pallas_fixpoint(case):
    """The kernel's design at its own tile, against the TPU kernel's
    fixpoint and the port's plain version."""
    _, m = case
    got = _model_fixpoint(m, KERNEL_TILE)
    np.testing.assert_array_equal(got, _pallas_fixpoint(m[None])[0])
    np.testing.assert_array_equal(
        got, ccl.ccl_fixpoint_plain(torch.from_numpy(m)[None])[0].numpy())


@pytest.mark.parametrize("tile", [(4, 8, 4), (3, 6, 3), (2, 16, 16),
                                  (5, 4, 2)], ids=str)
@pytest.mark.parametrize("seed", range(3))
def test_kernel_model_many_seams(tile, seed):
    """The same design with small tiles, so that a small mask has seams
    everywhere: random masks of three densities, a serpentine and a
    checkerboard, each against the plain version."""
    masks = [_random((23, 37), 50 + seed, density=d) for d in (0.3, 0.6, 0.9)]
    masks += [_serpentine(23, 37), _checkerboard(23, 37)]
    for i, m in enumerate(masks):
        want = ccl.ccl_fixpoint_plain(torch.from_numpy(m)[None])[0].numpy()
        np.testing.assert_array_equal(
            _model_fixpoint(m, tile, seed=seed), want, err_msg=f"mask {i}")


@pytest.mark.parametrize("jax_fn", ["labels", "labels_pallas"])
@pytest.mark.parametrize("shape", [(31, 127), (32, 128), (33, 129),
                                   (63, 255), (65, 257)], ids=str)
def test_plain_matches_jax_at_tile_boundaries(shape, jax_fn):
    """The yardstick the card holds the kernel to, pinned to the reference
    one pixel either side of the kernel's tile and of two tiles."""
    x = _random((2, *shape), sum(shape), density=0.6)
    want = getattr(jccl, jax_fn)(jnp.asarray(x))
    assert_summary_equal(ccl.labels(torch.from_numpy(x)), want)


def test_shape_checks_follow_the_grid():
    ccl.check_shape(65535, 32_000, 32_000)  # 1,024,000,000 < 2^30
    with pytest.raises(ValueError, match="batch 65536 exceeds 65535"):
        ccl.check_shape(65536, 4, 4)
    with pytest.raises(ValueError, match="sentinel"):
        ccl.check_shape(1, 1 << 15, 1 << 15)
