"""Platform plumbing: where the compile cache goes, the flax-free
``TrainState`` pytree, the device checks of ``chip_smoke.py`` and
``__graft_entry__.dryrun_multichip``, and the benchmark's peak table."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from weaksuppointcloudseg_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_into_the_checkout(monkeypatch,
                                                  restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.init_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # the same fixed path on every call: a moved cache never hits
    assert compile_cache.init_compile_cache() == path


def test_compile_cache_env_var_wins(monkeypatch, tmp_path,
                                    restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.init_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the code sets no other directory
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_dir_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _state():
    from weaksuppointcloudseg_tpu.train.state import TrainState

    tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-2)
    params = {"w": jnp.ones((3,)), "b": jnp.zeros((2,))}
    return TrainState(params=params, bn_state={"m": jnp.zeros((3,))},
                      opt_state=tx.init(params), step=jnp.asarray(0),
                      tx=tx)


def test_train_state_is_a_pytree_with_static_tx():
    state = _state()
    leaves, treedef = jax.tree_util.tree_flatten(state)
    assert all(isinstance(x, jax.Array) for x in leaves)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.tx is state.tx
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, state)
    moved = state.replace(step=jnp.asarray(5))
    assert int(moved.step) == 5 and moved.tx is state.tx


def test_train_state_apply_gradients_under_jit():
    state = _state()
    grads = jax.tree_util.tree_map(jnp.ones_like, state.params)
    new = jax.jit(lambda s, g: s.apply_gradients(g, 0.5))(state, grads)
    assert int(new.step) == 1
    assert float(new.params["w"][0]) < 1.0


def test_no_flax_on_the_train_path():
    code = ("import sys\n"
            "import weaksuppointcloudseg_tpu.train.loop\n"
            "import weaksuppointcloudseg_tpu.cli.train_shapenet\n"
            "assert 'flax' not in sys.modules, 'flax was imported'\n")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_gpu(tmp_path, where):
    """On the CPU, and in a directory holding only the script, it exits
    non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        with open(script) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        script = str(tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, script], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_dryrun_multichip_needs_the_devices():
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as graft
    finally:
        sys.path.remove(REPO)
    with pytest.raises(RuntimeError, match="needs 64 devices"):
        graft.dryrun_multichip(64)


@pytest.fixture
def bench():
    sys.path.insert(0, REPO)
    try:
        import bench
        yield bench
    finally:
        sys.path.remove(REPO)


def test_bench_peak_known_device(bench):
    assert bench.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12


def test_bench_peak_unknown_device_raises(bench):
    with pytest.raises(KeyError, match="PEAK_BF16_FLOPS"):
        bench.peak_bf16_flops("cpu")
