"""The port's multi-op platform against the JAX package's (``tests/test_ops.py``
is the JAX side's own suite): ops ``ccl`` and ``denoise`` through the
engine and the service, the ``denoise+ychg`` pipeline, and the op and
backend registries.

Inputs are seeded numpy arrays handed to both packages. Tolerance: exact,
dtypes included, everywhere except denoise's ``image`` on float32 inputs,
which is held to ``test_torch_denoise.assert_denoise_matches`` (within
1 ulp, at most 1 in 10^4 outputs differing; that module says why). The
pipeline's ychg output is exact on float32 inputs too.
"""

import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import YCHGConfig as JConfig  # noqa: E402
from repro.service import Service as JService  # noqa: E402
from repro.service import ServiceConfig as JServiceConfig  # noqa: E402
from repro_torch.configs.ychg_modis import engine_config_from_jax  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    CCLResult,
    DenoiseResult,
    Engine,
    EngineConfig,
    UnknownOpError,
    get_op,
    op_names,
    pipeline_op_key,
    registry,
    resolve,
    split_pipeline_key,
    validate_pipeline,
)
from repro_torch.kernels import ccl as kccl  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.service import Service, ServiceConfig, make_key  # noqa: E402
from test_torch_denoise import assert_denoise_matches  # noqa: E402

TIMEOUT = 300.0  # generous future bound: fail, never hang
NEW_OPS = ("ccl", "denoise")


def _masks(shape, seed, density=0.5):
    return (np.random.default_rng(seed).random(shape) < density).astype(
        np.uint8)


def _floats(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    x[rng.random(shape) < 0.05] = np.float32(4.0)   # impulse pixels
    x[rng.random(shape) < 0.3] = np.float32(0.0)
    return x


@pytest.fixture(scope="module")
def jax_engine():
    return JEngine(JConfig(backend="jax"))


def assert_host_matches(got: dict, want: dict, float_input: bool):
    """Every field: exact, dtype included, except a float32 input's
    denoised image (the denoise module's tolerance)."""
    assert set(got) == set(want)
    for f in want:
        g, w = got[f], np.asarray(want[f])
        if f == "image":
            assert_denoise_matches(g, w, float_input)
            continue
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


# ----------------------------------------------------------- op registry


def test_builtin_ops_registered():
    assert set(op_names()) == {"ychg", "ccl", "denoise"}
    assert {"ychg", "ccl", "denoise"} <= set(registry.registered_ops())
    for op in NEW_OPS:
        assert set(registry.backend_names(op)) == {"torch", "cuda"}
        assert get_op(op).result_type in (CCLResult, DenoiseResult)
    assert get_op("ccl").chain_field == "labels"
    assert get_op("denoise").chain_field == "image"
    assert get_op("ychg").chain_field is None


@pytest.mark.parametrize("op", NEW_OPS)
def test_auto_resolution_is_data(op):
    """cpu -> the plain reference, cuda -> the kernel."""
    assert resolve("auto", platform="cpu", op=op).name == "torch"
    assert resolve("auto", platform="cuda", op=op).name == "cuda"
    assert Engine(device="cpu").resolve_backend(op=op) == "torch"
    assert Engine(EngineConfig(backend="cuda"),
                  device="cpu").resolve_backend(op=op) == "cuda"


def test_unknown_op_is_a_typed_error_naming_registered_ops():
    with pytest.raises(UnknownOpError, match="ychg"):
        get_op("warp")
    with pytest.raises(UnknownOpError, match="warp"):
        resolve("auto", platform="cpu", op="warp")
    with pytest.raises(UnknownOpError):
        Engine(device="cpu").analyze(np.zeros((4, 4), np.uint8), op="warp")


def test_register_backend_for_op_is_live_immediately():
    fixed = kccl.labels(torch.ones((1, 2, 3), dtype=torch.uint8))
    eng = Engine(device="cpu")
    assert eng.resolve_backend(op="ccl") == "torch"
    gen = registry.generation()
    registry.register_backend(registry.BackendSpec(
        name="_test_ccl_stub", op="ccl", run=lambda x, c: fixed,
        supports_batch=True, supports_mesh=False, device_kinds=("cpu",),
        priority={"cpu": 999},
    ))
    try:
        assert registry.generation() > gen
        assert eng.resolve_backend(op="ccl") == "_test_ccl_stub"
        assert "_test_ccl_stub" not in registry.backend_names("ychg")
    finally:
        registry.unregister_backend("_test_ccl_stub", op="ccl")
    assert eng.resolve_backend(op="ccl") == "torch"


def test_carried_jax_config_resolves_every_op():
    cfg = engine_config_from_jax(dataclasses.asdict(JConfig()))
    eng = Engine(cfg, device="cpu")
    assert cfg.backend == "auto"
    assert {op: eng.resolve_backend(op=op) for op in op_names()} == {
        "ychg": "torch", "ccl": "torch", "denoise": "torch"}


# ---------------------------------------------------------------- engine


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("op", NEW_OPS)
def test_analyze_batch_matches_jax(op, backend, dtype, jax_engine):
    stack = (_masks((3, 18, 25), 7) if dtype == "uint8"
             else _floats((3, 18, 25), 7))
    eng = Engine(EngineConfig(backend=backend), device="cpu")
    got = eng.analyze_batch(stack, op=op)
    want = jax_engine.analyze_batch(stack, op=op)
    assert got.batched and got.batch_size == 3
    assert got.event is None and got.block_until_ready() is got
    assert_host_matches(got.to_host(), want.to_host(), dtype == "float32")


@pytest.mark.parametrize("op", NEW_OPS)
def test_analyze_single_and_default_op(op, jax_engine):
    img = _masks((21, 30), 8)
    got = Engine(device="cpu", op=op).analyze(img)
    want = jax_engine.analyze(img, op=op)
    assert not got.batched and got.batch_size == 1
    assert_host_matches(got.to_host(), want.to_host(), False)


# ------------------------------------------------------------- pipelines


def test_pipeline_spec_validation():
    assert validate_pipeline(["denoise", "ychg"]) == ("denoise", "ychg")
    assert pipeline_op_key(("denoise", "ychg")) == "denoise+ychg"
    assert split_pipeline_key("denoise+ychg") == ("denoise", "ychg")
    assert split_pipeline_key("ychg") == ("ychg",)
    with pytest.raises(ValueError):
        validate_pipeline([])
    with pytest.raises(UnknownOpError):
        validate_pipeline(["denoise", "warp"])
    with pytest.raises(ValueError, match="terminal"):
        validate_pipeline(["ychg", "ccl"])
    with pytest.raises(ValueError, match="run_pipeline expects"):
        Engine(device="cpu").run_pipeline(np.zeros((4, 4)), ["denoise"])


@pytest.mark.parametrize("backend", ["torch", "auto"])
@pytest.mark.parametrize("stages", [("denoise", "ychg"), ("ccl", "ychg"),
                                    ("denoise", "ccl")])
def test_run_pipeline_matches_jax(stages, backend, jax_engine):
    """Float32 input: the ychg output is exact even where a denoised value
    could be 1 ulp off, since 1 ulp never changes whether it is nonzero."""
    stack = _floats((4, 20, 28), 9)
    eng = Engine(EngineConfig(backend=backend), device="cpu")
    got = eng.run_pipeline(stack, list(stages))
    want = jax_engine.run_pipeline(stack, list(stages))
    assert type(got) is get_op(stages[-1]).result_type
    assert_host_matches(got.to_host(), want.to_host(), True)


def test_run_pipeline_valid_hw_matches_jax(jax_engine):
    stack = _floats((3, 16, 16), 10)
    hw = np.array([[16, 16], [9, 13], [0, 0]], np.int32)
    seen = []
    got = Engine(device="cpu").run_pipeline(
        stack, ["denoise", "ychg"], valid_hw=hw,
        on_stage=lambda name, t0, t1: seen.append((name, t1 >= t0)))
    want = jax_engine.run_pipeline(stack, ["denoise", "ychg"], valid_hw=hw)
    assert_host_matches(got.to_host(), want.to_host(), True)
    assert seen == [("ingest", True), ("denoise", True), ("ychg", True)]


def test_run_pipeline_equals_sequential_dispatch():
    stack = _floats((4, 20, 28), 11)
    eng = Engine(device="cpu")
    piped = eng.run_pipeline(stack, ["denoise", "ychg"]).to_host()
    mid = eng.analyze_batch(stack, op="denoise")
    want = eng.analyze_batch(mid.image, op="ychg").to_host()
    assert_host_matches(piped, want, False)


# --------------------------------------------------------------- service


RAGGED = [(30, 30), (17, 25), (32, 9), (1, 1), (5, 32)]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("op", NEW_OPS)
def test_service_submit_matches_jax_service(op, backend):
    """Ragged masks sharing one 32-bucket, duplicates included: every port
    result equals the JAX service's and the reference on the raw mask."""
    masks = [_masks(s, i) for i, s in enumerate(RAGGED)]
    masks += [masks[1].copy()]
    cfg = dict(bucket_sides=(32,), max_batch=4, max_delay_ms=1.0)
    eng = Engine(EngineConfig(backend=backend), device="cpu")
    with Service(eng, ServiceConfig(**cfg)) as svc:
        got = [f.result(timeout=TIMEOUT)
               for f in [svc.submit(m, op=op) for m in masks]]
    with JService(JEngine(JConfig(backend="jax")),
                  JServiceConfig(**cfg)) as js:
        want = [f.result(timeout=TIMEOUT)
                for f in [js.submit(m, op=op) for m in masks]]
    spec = get_op(op)
    for g, w, m in zip(got, want, masks):
        assert not g.batched and g.batch_size == 1
        assert_host_matches(g.to_host(), w.to_host(), False)
        ref = spec.from_summary(spec.reference(torch.from_numpy(m)[None]),
                                True)
        for f in spec.fields:
            assert torch.equal(getattr(g, f), getattr(ref, f)), f


def test_service_pipeline_matches_jax_and_separate_requests():
    """The compound request through the bucketed service (padded canvas,
    re-zeroing between stages) equals the JAX service's and feeding
    stage 1's cropped output back in as a stage 2 request."""
    imgs = [_floats(s, 20 + i) for i, s in enumerate(RAGGED)]
    cfg = dict(bucket_sides=(32,), max_batch=4, max_delay_ms=1.0)
    with Service(Engine(device="cpu"), ServiceConfig(**cfg)) as svc:
        piped = [f.result(timeout=TIMEOUT) for f in
                 [svc.submit_pipeline(x, ["denoise", "ychg"]) for x in imgs]]
        seq = []
        for x in imgs:
            mid = svc.submit(x, op="denoise").result(timeout=TIMEOUT)
            seq.append(svc.submit(mid.to_host()["image"],
                                  op="ychg").result(timeout=TIMEOUT))
        again = svc.pipeline(imgs[0], ["denoise", "ychg"], timeout=TIMEOUT)
        m = svc.metrics()
    with JService(JEngine(JConfig(backend="jax")),
                  JServiceConfig(**cfg)) as js:
        want = [js.pipeline(x, ["denoise", "ychg"], timeout=TIMEOUT)
                for x in imgs]
    for p, s, w in zip(piped, seq, want):
        assert not p.batched
        assert_host_matches(p.to_host(), w.to_host(), True)
        assert_host_matches(p.to_host(), s.to_host(), True)
    assert again is piped[0]                     # served from the cache
    stages = {dict(labels).get("stage") for labels, _snap in m.stage_hists}
    assert {"pipeline.denoise", "pipeline.ychg"} <= stages


def test_cache_entries_are_namespaced_by_op():
    mask = _masks((16, 16), 12)
    cfg = EngineConfig()
    assert make_key(mask, "torch", cfg, op="ychg") != \
        make_key(mask, "torch", cfg, op="ccl")
    assert make_key(mask, "torch", cfg, op="denoise") != \
        make_key(mask, "torch+torch", cfg, op="denoise+ychg")
    with Service(Engine(device="cpu"),
                 ServiceConfig(bucket_sides=(16,))) as svc:
        svc.submit(mask, op="ychg").result(timeout=TIMEOUT)
        svc.submit(mask, op="ccl").result(timeout=TIMEOUT)   # no cross-op hit
        m1 = svc.metrics()
        svc.submit(mask, op="ccl").result(timeout=TIMEOUT)   # same-op repeat
        m2 = svc.metrics()
    assert m1.cache_misses == 2 and m1.cache_hits == 0
    assert m2.cache_hits == 1


def test_per_op_bucket_ladder_and_max_batch():
    cfg = ServiceConfig(bucket_sides=(64, 128), max_batch=8,
                        op_bucket_sides=(("ccl", (32,)),),
                        op_max_batch=(("ccl", 2),))
    assert cfg.bucket_sides_for("ccl") == (32,)
    assert cfg.max_batch_for("ccl") == 2 and cfg.max_batch_for("ychg") == 8
    with Service(Engine(device="cpu"), cfg) as svc:
        svc.submit(_masks((20, 20), 13), op="ccl").result(timeout=TIMEOUT)
        m = svc.metrics()
    assert (1, 32, 32) in m.compiled_shapes


@pytest.mark.parametrize("op", NEW_OPS)
def test_crops_copy_out_of_the_batch(op):
    """A served ccl/denoise result owns a copy of its native region, so the
    result cache never keeps a whole bucket batch alive."""
    mask = _masks((9, 13), 14)
    with Service(Engine(device="cpu"),
                 ServiceConfig(bucket_sides=(64,))) as svc:
        out = svc.submit(mask, op=op).result(timeout=TIMEOUT)
    t = out.labels if op == "ccl" else out.image
    assert tuple(t.shape) == (1, 9, 13) and t.is_contiguous()
    assert t.untyped_storage().nbytes() == 9 * 13 * 4


def test_submit_rejects_pipeline_keys_pointing_at_submit_pipeline():
    with Service(Engine(device="cpu"),
                 ServiceConfig(bucket_sides=(16,))) as svc:
        with pytest.raises(ValueError, match="submit_pipeline"):
            svc.submit(np.zeros((8, 8), np.uint8), op="denoise+ychg")


# ----------------------------------------------------------- serve command


@pytest.mark.parametrize("op", NEW_OPS)
def test_serve_cli_op_on_cpu(op, capsys):
    report = serve.serve_ychg(argparse.Namespace(
        res=32, batch=2, overload=False, device="cpu", workload="ychg",
        op=op))
    out = capsys.readouterr().out
    assert f"{op} service[torch] on cpu" in out
    assert report.backend == "torch" and report.cached_hit_rate == 1.0
    spec = get_op(op)
    for res, m in zip(report.cold + report.warm, serve.derived_masks(32, 4)):
        ref = spec.reference(torch.from_numpy(m)[None])
        for f in spec.fields:
            assert torch.equal(getattr(res, f), getattr(ref, f)), f


def test_pipeline_pass_on_cpu():
    masks = [m.astype(np.float32) for m in serve.derived_masks(32, 3)]
    rep = serve.pipeline_pass(Engine(device="cpu"), masks)
    assert rep.backend == "torch+torch" and rep.batches >= 1
    assert {"pipeline.denoise", "pipeline.ychg"} <= set(rep.stage_s)
    eng = Engine(device="cpu")
    for res, m in zip(rep.results, masks):
        want = eng.run_pipeline(m[None], ["denoise", "ychg"])
        assert_host_matches(res.to_host(),
                            dataclasses.replace(want, batched=False)
                            .to_host(), False)
