"""Parity: the port's denoise (plain version and CPU wrapper) against the
JAX package's ``denoise`` (jnp reference) and ``denoise_pallas`` (Pallas
kernel in interpret mode), on the same seeded numpy inputs.

Tolerances:
  * integer and bool inputs: exact, bit for bit, dtype included;
  * float32 inputs: every output within 1 ulp (``np.spacing``) of the JAX
    output, and at most 1 in 10^4 outputs differing at all (so none, at
    the sizes here). Reason: the reference's float32 arithmetic is XLA:CPU's,
    which contracts the centre tap of the sum of squares and the deviation
    ``x - mean`` into FMAs and flushes subnormals; the plain version
    reproduces those FMAs, the flush and a correctly rounded sqrt, and the
    bound leaves room for any other contraction XLA may choose on another
    CPU (ROADMAP.md, Queue B 3). ``tests/test_torch_subnormal.py`` holds
    subnormal inputs bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import denoise as jdn  # noqa: E402
from repro_torch.kernels import denoise as dn  # noqa: E402

RAGGED = [(1, 1), (1, 7), (6, 1), (17, 23), (20, 17), (33, 64)]


def _input(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        x = rng.standard_normal(shape).astype(np.float32) * np.float32(40)
        x[rng.random(shape) < 0.05] = np.float32(255)   # impulse pixels
        return x
    mask = rng.random(shape) < 0.5
    if dtype == "bool":
        return mask
    return (mask * rng.integers(0, 256, shape)).astype(dtype)


def assert_denoise_matches(got: np.ndarray, want: np.ndarray,
                           float_input: bool) -> int:
    """The module's tolerance; returns the number of differing outputs."""
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    if not float_input:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        return 0
    same = ((got.view(np.int32) == want.view(np.int32))
            | (np.isnan(got) & np.isnan(want)))
    diff = ~same
    assert np.all(np.abs(got[diff] - want[diff])
                  <= np.spacing(np.abs(want[diff]))), "more than 1 ulp off"
    assert diff.sum() <= got.size // 10_000, f"{diff.sum()} outputs differ"
    return int(diff.sum())


@pytest.mark.parametrize("jax_fn", ["denoise", "denoise_pallas"])
@pytest.mark.parametrize("dtype", ["uint8", "bool", "int32", "float32"])
@pytest.mark.parametrize("shape", RAGGED)
def test_plain_matches_jax(shape, dtype, jax_fn):
    x = _input((2, *shape), dtype, seed=sum(shape))
    want = np.asarray(getattr(jdn, jax_fn)(jnp.asarray(x)).image)
    got = dn.denoise(torch.from_numpy(x)).image
    assert got.dtype == torch.float32
    assert_denoise_matches(got.numpy(), want, dtype == "float32")


def test_float32_special_values_match_jax():
    """-0.0, NaN, +-inf, overflowing squares (3e38) and underflowing ones
    (1e-30) go through the same IEEE arithmetic: a NaN comparison is false,
    so a NaN pixel passes through. Subnormal inputs have their own module,
    ``tests/test_torch_subnormal.py``."""
    rng = np.random.default_rng(5)
    vals = np.array([0.0, -0.0, 1.5, -2.0, np.nan, np.inf, -np.inf, 3e38,
                     1e-30], np.float32)
    x = vals[rng.integers(0, len(vals), (3, 21, 30))]
    want = np.asarray(jdn.denoise(jnp.asarray(x)).image)
    got = dn.denoise(torch.from_numpy(x)).image.numpy()
    assert_denoise_matches(got, want, float_input=True)


def test_float32_sweep_stays_within_tolerance():
    """A larger float32 sweep than the ragged cases (~60k outputs), mixed
    magnitudes, against the jitted reference."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((6, 77, 131))
         * 10.0 ** rng.integers(-3, 4, (6, 77, 131))).astype(np.float32)
    want = np.asarray(jdn.denoise(jnp.asarray(x)).image)
    got = dn.denoise(torch.from_numpy(x)).image.numpy()
    assert_denoise_matches(got, want, float_input=True)


def test_fma_emulation_rounds_once():
    """``_fma_sq`` is fma(x, x, partial) rounded once: it differs from
    rounding x * x first exactly where a float64 reference rounded to odd
    says it must."""
    x = torch.tensor([1.0 + 2.0 ** -12, 3.0, 1e-20], dtype=torch.float32)
    p = torch.tensor([-1.0, 0.5, 1.0], dtype=torch.float32)
    got = dn._fma_sq(x, p)
    # (1 + 2^-12)^2 - 1 = 2^-11 + 2^-24, exact in float32 only when fused
    assert got[0].item() == 2.0 ** -11 + 2.0 ** -24
    assert (x[0] * x[0] + p[0]).item() == 2.0 ** -11
    assert got[1].item() == 9.5 and got[2].item() == 1.0
    assert got.dtype == torch.float32


def test_wrapper_on_cpu_runs_the_plain_version():
    x = torch.from_numpy(_input((3, 19, 40), "uint8", seed=1))
    before = dn.LAUNCHES["denoise"]
    got = dn.denoise_kernel(x)
    assert torch.equal(got.image, dn.denoise_plain(x))
    assert dn.LAUNCHES["denoise"] == before   # no kernel launched


def test_wrapper_refuses_other_devices_and_shapes():
    with pytest.raises(ValueError, match="CUDA tensor"):
        dn.denoise_kernel(torch.zeros((1, 4, 4), device="meta"))
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        dn.denoise_kernel(torch.zeros((4, 4)))
    with pytest.raises(TypeError):
        dn.denoise_kernel(np.zeros((1, 4, 4)))


def test_empty_stacks():
    for shape in [(0, 4, 4), (2, 0, 5), (2, 5, 0)]:
        out = dn.denoise(torch.zeros(shape, dtype=torch.uint8)).image
        assert out.shape == shape and out.dtype == torch.float32


def test_pad_invariance():
    """Zero padding below and to the right leaves every pixel whose window
    lies inside the native image unchanged."""
    img = _input((1, 14, 18), "float32", seed=6)
    padded = np.zeros((1, 20, 24), np.float32)
    padded[0, :14, :18] = img[0]
    base = dn.denoise(torch.from_numpy(img)).image
    pad = dn.denoise(torch.from_numpy(padded)).image
    assert torch.equal(pad[0, :13, :17], base[0, :13, :17])
