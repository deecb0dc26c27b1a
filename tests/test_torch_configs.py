"""The port's configs and host code against the JAX package's, exactly.

Every architecture's ``config()`` and ``smoke()`` (as
``dataclasses.asdict``), ``list_archs``, ``shapes_for`` and the shape
constants; the workload's legacy ``block_w``/``block_h`` views (ROADMAP
Queue C 7); the public names of the two packages, module by module, with
the names still to be ported listed once, each with its ROADMAP item
(Queue C 8); every ``ModelConfig`` field the reference reads, read by
the port in the same module, with the one stated exception
(``CONFIG_READS_NOT_PORTED``); and the synthetic ``TokenDataset``
streams. All of it is host code, so the bar is equality.
"""

import dataclasses
import importlib
import importlib.util
import itertools
import pkgutil
import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro  # noqa: E402
import repro.configs as jconfigs  # noqa: E402
from repro.configs import archs as jarchs  # noqa: E402
from repro.configs import ychg_modis as jmodis  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.configs import ychg_modis as tmodis  # noqa: E402
from repro_torch.data import synthetic as tsynthetic  # noqa: E402

ARCHS = jconfigs.list_archs()

# What the port does not have yet, by module: None for a whole module,
# else the public names it lacks, each with the ROADMAP item that ports it.
NOT_PORTED = {
    # jax.jit of core.ychg.analyze: no counterpart (repro_torch.core says so)
    "repro.core": ({"analyze_jit"}, "none: a jax.jit wrapper"),
}

# ModelConfig fields the reference reads (``cfg.<field>``) in a module
# whose counterpart in the port does not, each with the reason
CONFIG_READS_NOT_PORTED = {
    ("models/model.py", "scan_layers"):
        "the reference's choice between lax.scan and an unrolled loop over "
        "the same math, how XLA traces the group loop; eager torch runs "
        "the loop as it is",
}


def _modules(package) -> dict:
    """Module name -> whether it is a package. Only packages are imported
    (importing some of the JAX package's modules sets XLA flags)."""
    return {package.__name__: True, **{
        m.name: m.ispkg for m in pkgutil.walk_packages(
            package.__path__, package.__name__ + ".")}}


def _public(module) -> set:
    return set(getattr(module, "__all__", ()))


def _port_name(name: str) -> str:
    return "repro_torch" + name[len("repro"):]


def _exists(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:   # its parent package is missing
        return False


@pytest.mark.parametrize("name", ARCHS)
def test_arch_config_and_smoke_match(name):
    assert (dataclasses.asdict(tconfigs.get_config(name))
            == dataclasses.asdict(jconfigs.get_config(name)))
    assert (dataclasses.asdict(tarchs.smoke_config(name))
            == dataclasses.asdict(jarchs.smoke_config(name)))
    assert sorted(tarchs.SMOKE) == sorted(jarchs.SMOKE)


def test_list_archs_shapes_and_constants_match():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for name in ARCHS:
        got = tconfigs.shapes_for(tconfigs.get_config(name))
        want = jconfigs.shapes_for(jconfigs.get_config(name))
        assert ([dataclasses.asdict(s) for s in got]
                == [dataclasses.asdict(s) for s in want]), name
    for const in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert (dataclasses.asdict(getattr(tconfigs, const))
                == dataclasses.asdict(getattr(jconfigs, const))), const
    assert len(tconfigs.ALL_SHAPES) == len(jconfigs.ALL_SHAPES) == 4


def test_model_config_derived_fields_and_checks():
    kw = dict(name="t", family="dense", num_layers=4, d_model=40,
              num_heads=5, num_kv_heads=1, d_ff=64, vocab_size=11)
    for cfgs in (jconfigs, tconfigs):
        pat = (cfgs.LayerSpec("mamba", "mlp"), cfgs.LayerSpec("attn", "moe"))
        c = cfgs.ModelConfig(layer_pattern=pat, **kw)
        assert (c.head_dim, c.ssm_dt_rank, c.num_groups) == (8, 3, 2)
        assert not c.is_attention_free and c.has_full_attention
        s = c.scaled(layer_pattern=(cfgs.LayerSpec("rwkv", "rwkv_ffn"),))
        assert s.is_attention_free and not s.has_full_attention
        with pytest.raises(AssertionError):
            cfgs.ModelConfig(**{**kw, "num_layers": 3}, layer_pattern=pat)
        with pytest.raises(KeyError):
            cfgs.get_config("no-such-arch")


def test_workload_legacy_block_knobs():
    """Queue C 7: the two flat knobs are views of the engine section."""
    want, got = jmodis.config(), tmodis.config()
    assert (got.block_w, got.block_h) == (want.block_w, want.block_h)
    assert (got.block_w, got.block_h) == (128, 2048)
    custom = dataclasses.replace(
        got, engine=dataclasses.replace(got.engine, block_w=64, block_h=512))
    assert (custom.block_w, custom.block_h) == (64, 512)


def test_public_names_match_module_by_module():
    """Queue C 8: every module of the JAX package has a counterpart in the
    port, and every name a package exports (``__all__``) the port exports
    too, apart from what ``NOT_PORTED`` lists. A listed gap that the port
    has closed fails too, so the list shrinks as the port grows."""
    modules = _modules(repro)
    for name, ispkg in modules.items():
        gap, _ = NOT_PORTED.get(name, (set(), None))
        port = _port_name(name)
        exists = _exists(port)
        if gap is None:
            assert not exists, f"{port} exists: drop it from NOT_PORTED"
            continue
        assert exists, f"{port} is missing"
        if not ispkg:
            assert not gap, name
            continue
        missing = (_public(importlib.import_module(name))
                   - _public(importlib.import_module(port)))
        assert missing == gap, (name, sorted(missing), sorted(gap))
    assert set(NOT_PORTED) <= set(modules)


def _config_reads(package) -> dict:
    """Module path (relative to the package, ``configs/`` left out) ->
    the ``ModelConfig`` fields its source reads as ``cfg.<field>`` or
    ``getattr(cfg, "<field>", ...)``."""
    fields = {f.name for f in dataclasses.fields(tconfigs.ModelConfig)}
    root = Path(package.__path__[0])
    out = {}
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if rel.startswith("configs/"):
            continue
        src = path.read_text()
        reads = (set(re.findall(r"\bcfg\.(\w+)", src))
                 | set(re.findall(r"getattr\(cfg, \"(\w+)\"", src))) & fields
        if reads:
            out[rel] = reads
    return out


def test_every_config_field_the_reference_reads_the_port_reads():
    """A guard against a config field the port keeps and ignores (as
    ``remat`` and ``ssm_chunk`` were until the port checkpointed): every
    field a module of the reference reads, the port's module of the same
    path reads too, apart from ``CONFIG_READS_NOT_PORTED``; a listed
    exception the port has come to read fails too."""
    import repro_torch

    want, got = _config_reads(repro), _config_reads(repro_torch)
    missing = {(module, field) for module, fields in want.items()
               for field in fields - got.get(module, set())}
    assert missing == set(CONFIG_READS_NOT_PORTED), sorted(missing)
    assert {"remat", "ssm_chunk"} <= got["models/model.py"] | got[
        "models/ssm.py"] | got["models/rwkv.py"]


@pytest.mark.parametrize("package,names", [
    ("kernels", {"ops", "ref", "analyze_fused"}),
    ("data", {"modis", "pipeline", "scenes", "synthetic"}),
])
def test_package_exports_resolve(package, names):
    """Queue C 8: the re-exports are attributes, and the same objects as
    the submodules' (importing the kernels builds nothing)."""
    mod = importlib.import_module(f"repro_torch.{package}")
    assert set(mod.__all__) == names
    for n in names:
        assert getattr(mod, n) is not None
    if package == "kernels":
        from repro_torch.kernels import ops

        assert mod.analyze_fused is ops.analyze_fused


@pytest.mark.parametrize("seed,vocab,seq,batch", [
    (0, 64, 8, 8), (3, 1000, 33, 4), (7, 50, 16, 6)])
def test_token_dataset_streams_match(seed, vocab, seq, batch):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    want = jsynthetic.TokenDataset(jsynthetic.TokenDatasetConfig(**kw))
    got = tsynthetic.TokenDataset(tsynthetic.TokenDatasetConfig(**kw))
    np.testing.assert_array_equal(got.patterns, want.patterns)
    for step in (0, 1, 5):
        for host, hosts in ((0, 1), (0, 2), (1, 2)):
            a, b = got.batch(step, host, hosts), want.batch(step, host, hosts)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])
    for a, b in itertools.islice(zip(got.iter(2), want.iter(2)), 3):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
