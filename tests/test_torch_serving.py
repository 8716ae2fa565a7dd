"""Port ``ServeEngine`` vs the JAX ``ServeEngine`` on the CPU, and the
port's import boundary.

Greedy ids are identical to JAX's for the reduced qwen2-0.5b, the bench
tiny config and the reduced xlstm-350m (same weights, carried across with
``weights.from_jax``).
Temperature decoding draws from the port's ``jax.random`` twin with JAX's
key schedule, so the same seed gives JAX's ids too.
"""
import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import bench_tiny_config as j_tiny
from repro.configs.base import get_config as jget
from repro.models import model as JM
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import weights
from repro_torch.configs.base import bench_tiny_config as t_tiny
from repro_torch.configs.base import get_config as tget
from repro_torch.serving.engine import ServeEngine

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _configs(name):
    if name == "bench_tiny":
        return j_tiny(), t_tiny()
    return jget(name).reduced(), tget(name).reduced()


def _engines(name):
    jc, tc = _configs(name)
    params = JM.init_model(jc, jax.random.PRNGKey(0))
    tp = weights.from_jax(tc, jax.tree.map(np.asarray, params), device="cpu")
    prompts = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 7),
                                                dtype=np.int32)
    return JaxEngine(jc, params), ServeEngine(tc, tp, device="cpu"), prompts


@pytest.mark.parametrize("name", ["qwen2-0.5b", "bench_tiny", "xlstm-350m"])
def test_greedy_ids_equal_jax(name):
    jax_engine, engine, prompts = _engines(name)
    want = jax_engine.generate(prompts, n_new=6, temperature=0.0)
    got = engine.generate(prompts, n_new=6, temperature=0.0)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)


def test_temperature_decode_seeded_determinism():
    _, engine, prompts = _engines("bench_tiny")
    a = engine.generate(prompts, n_new=8, temperature=0.8, seed=7)
    b = engine.generate(prompts, n_new=8, temperature=0.8, seed=7)
    np.testing.assert_array_equal(a, b)
    c = engine.generate(prompts, n_new=8, temperature=0.8, seed=8)
    assert not np.array_equal(a, c), "different seeds, identical sample path"
    greedy = engine.generate(prompts, n_new=8, temperature=0.0, seed=7)
    hot = engine.generate(prompts, n_new=8, temperature=2.0, seed=7)
    assert not np.array_equal(greedy, hot)
    assert np.all((0 <= hot) & (hot < engine.cfg.vocab_size))


@pytest.mark.parametrize("name", ["qwen2-0.5b", "xlstm-350m"])
def test_temperature_ids_equal_jax(name):
    """``categorical`` from ``PRNGKey(seed)`` for the first token, then
    from a key split off once a token, as the JAX engine draws."""
    jax_engine, engine, prompts = _engines(name)
    for seed in (0, 7):
        want = jax_engine.generate(prompts, n_new=8, temperature=0.8,
                                   seed=seed)
        got = engine.generate(prompts, n_new=8, temperature=0.8, seed=seed)
        np.testing.assert_array_equal(got, want)


def test_engine_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(t_tiny(), {})


@pytest.mark.parametrize("name", ["qwen2-0.5b", "xlstm-350m"])
def test_generate_past_max_len_equals_jax(name):
    """A request of 507 prompt and 6 new tokens passes the default
    max_len of 512; JAX never reads max_len (its caches grow to S +
    n_new), and the port serves the same greedy ids."""
    jax_engine, engine, _ = _engines(name)
    prompt = np.random.default_rng(1).integers(
        0, engine.cfg.vocab_size, (1, 507), dtype=np.int32)
    assert prompt.shape[1] + 6 > engine.max_len == jax_engine.max_len
    want = jax_engine.generate(prompt, n_new=6, temperature=0.0)
    got = engine.generate(prompt, n_new=6, temperature=0.0)
    np.testing.assert_array_equal(got, want)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
