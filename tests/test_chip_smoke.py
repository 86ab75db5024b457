"""chip_smoke.py at a tiny size on the CPU: the GPU guard, every phase's
parity checks, the four-card path on virtual devices, the float32
matmul precision of every engine it drives, the compile-cache helper,
and the engines' independence from PyYAML."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
from jax.extend.core import ClosedJaxpr, Jaxpr

import chip_smoke
from direct_data_driven_mpc_jax.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_refuses_to_run_without_a_gpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert "'cpu'" in str(exc.value.code)


TINY = {
    "A": dict(batches=(8,), T=60, K=10, n_check=2),
    "B": dict(B=4, T=60, n_check=2),
    "C": dict(B=8, T=40),
    "D": dict(B=8, T=40),
    "E": dict(B=4, T=20, n_check=2),
}
FOUR_TINY = dict(batches=(16,), B_admm=16, T=40, B_mesh=8, T_mesh=10)


@pytest.mark.parametrize("phase", sorted(TINY))
def test_phase_passes_at_tiny_size(phase, capsys):
    chip_smoke.PHASES[phase](**TINY[phase])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[{phase} ") and "compile" in line


def test_four_card_path_on_virtual_devices(capsys):
    chip_smoke.four_cards(**FOUR_TINY)
    out = capsys.readouterr().out
    assert out.count("[4x ") == 4


def _f32_products_below_highest(jaxpr, found):
    """Collect the dot/conv equations with a float32 operand whose
    precision is not HIGHEST: on the GPU those run as TF32."""
    hi = jax.lax.Precision.HIGHEST
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
            if any(v.aval.dtype == jnp.float32 for v in eqn.invars):
                prec = eqn.params.get("precision")
                if not (isinstance(prec, tuple)
                        and all(p == hi for p in prec)):
                    found.append(str(eqn.source_info.traceback))
        for val in eqn.params.values():
            for sub in val if isinstance(val, (tuple, list)) else (val,):
                if isinstance(sub, ClosedJaxpr):
                    _f32_products_below_highest(sub.jaxpr, found)
                elif isinstance(sub, Jaxpr):
                    _f32_products_below_highest(sub, found)


@pytest.mark.parametrize("phase", sorted(TINY) + ["four"])
def test_engine_f32_matmuls_pin_highest(phase, monkeypatch, capsys):
    """Every float32 product of the engines each phase drives is pinned
    to HIGHEST; the rest are the explicit bf16 passes."""
    jaxprs = []
    real_timed = chip_smoke.timed

    def traced_timed(fn, *args):
        jaxprs.append(jax.make_jaxpr(fn)(*args).jaxpr)
        return real_timed(fn, *args)

    monkeypatch.setattr(chip_smoke, "timed", traced_timed)
    if phase == "four":
        chip_smoke.four_cards(**FOUR_TINY)
    else:
        chip_smoke.PHASES[phase](**TINY[phase])
    found = []
    for jaxpr in jaxprs:
        _f32_products_below_highest(jaxpr, found)
    assert jaxprs and not found, found[0]


def test_compile_cache_follows_environment(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code.
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_fixed_checkout_path(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.compile_cache_dir()
    assert first == compile_cache.compile_cache_dir()
    assert first == os.path.join(ROOT, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == first
        assert jax.config.jax_compilation_cache_dir == first
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_control_package_imports_without_yaml():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'yaml' or name.startswith('yaml.'):\n"
        "            raise ImportError('yaml blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import direct_data_driven_mpc_jax.control\n"
        "import direct_data_driven_mpc_jax.ops.fused_admm\n"
        "assert 'yaml' not in sys.modules\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
