"""The port's lowering switches (``occ_gnn_tpu_torch/ops/config.py``)
against the JAX package's ``ops/config.py``: the same environment
variables, choices, defaults and error texts, and the same "read once,
then kept" rule.
"""

import pytest

from occ_gnn_tpu.ops import config as jcfg
from occ_gnn_tpu_torch.ops import config as tcfg

# reader name, JAX cache global, environment variable, choices, default
SWITCHES = [
    ("dense_agg", "_dense_agg", "OCC_DENSE_AGG", ("unrolled", "tiled"),
     "unrolled"),
    ("gat_attention", "_gat_attention", "OCC_GAT_ATTENTION",
     ("batched", "online", "tiled"), "batched"),
    ("gat_agg", "_gat_agg", "OCC_GAT_AGG", ("fma", "einsum"), "einsum"),
    ("gat_remat", "_gat_remat", "OCC_GAT_REMAT", ("none", "dots"), "none"),
    ("device_sample", "_device_sample", "OCC_DEVICE_SAMPLE",
     ("randint", "bitsf32", "bitsf32_dk", "window"), "randint"),
]
IDS = [s[0] for s in SWITCHES]


@pytest.fixture
def fresh(monkeypatch):
    """Both packages with nothing read yet; restored afterwards."""
    for name, jglobal, env, _, _ in SWITCHES:
        monkeypatch.setattr(jcfg, jglobal, None)
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setattr(tcfg, "_values", {})


def _readers(name):
    return (getattr(jcfg, f"{name}_impl"), getattr(tcfg, f"{name}_impl"),
            getattr(jcfg, f"set_{name}_impl"),
            getattr(tcfg, f"set_{name}_impl"))


@pytest.mark.parametrize("switch", SWITCHES, ids=IDS)
def test_choices_and_default_match_jax(fresh, monkeypatch, switch):
    name, jglobal, env, choices, default = switch
    jread, tread, _, _ = _readers(name)
    assert tcfg._SWITCHES[name] == (env, choices, default)
    assert jread() == tread() == default
    for choice in choices:
        monkeypatch.setattr(jcfg, jglobal, None)
        monkeypatch.setattr(tcfg, "_values", {})
        monkeypatch.setenv(env, choice)
        assert jread() == tread() == choice


@pytest.mark.parametrize("switch", SWITCHES, ids=IDS)
def test_read_once_then_kept_and_setter_wins(fresh, monkeypatch, switch):
    name, _, env, choices, default = switch
    jread, tread, jset, tset = _readers(name)
    assert jread() == tread() == default
    monkeypatch.setenv(env, choices[-1] if choices[-1] != default
                       else choices[0])
    assert jread() == tread() == default  # kept: the variable is not reread
    other = next(c for c in choices if c != default)
    jset(other)
    tset(other)
    assert jread() == tread() == other


@pytest.mark.parametrize("switch", SWITCHES, ids=IDS)
def test_error_texts_match_jax(fresh, monkeypatch, switch):
    name, _, env, _, _ = switch
    jread, tread, jset, tset = _readers(name)
    monkeypatch.setenv(env, "bogus")
    texts = []
    for read in (jread, tread):
        with pytest.raises(ValueError) as err:
            read()
        texts.append(str(err.value))
    assert texts[0] == texts[1]
    assert texts[1].startswith(f"{env}='bogus' is not one of")
    texts = []
    for setter in (jset, tset):
        with pytest.raises(ValueError) as err:
            setter("bogus")
        texts.append(str(err.value))
    assert texts[0] == texts[1] == (
        f"{name} impl must be one of {tcfg._SWITCHES[name][1]}")


def test_gat_tile_reads_its_variable_each_call(monkeypatch):
    monkeypatch.delenv("OCC_GAT_TILE", raising=False)
    assert tcfg.gat_tile() == 4096
    monkeypatch.setenv("OCC_GAT_TILE", "32")
    assert tcfg.gat_tile() == 32


def test_no_pallas_switch():
    """On a CUDA tensor the port always launches its kernel: it has no
    counterpart of ``use_pallas``."""
    assert not hasattr(tcfg, "use_pallas")
    assert not hasattr(tcfg, "set_use_pallas")
