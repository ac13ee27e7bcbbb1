"""The PyTorch/CUDA port stands alone: it imports neither jax nor the JAX
package, its sources name neither, and its GPU entry points refuse to run
without a card instead of carrying on on the CPU."""

import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
PORT = ROOT / "verifiable_mpc_tpu_torch"
SCRIPTS = ("chip_smoke.py", "chip_profile.py", "chip_variants.py")
_FORBIDDEN = re.compile(
    r"verifiable_mpc_tpu\.|^\s*import jax|^\s*from jax", re.MULTILINE
)
SOURCES = sorted(
    [p for p in PORT.rglob("*")
     if p.suffix in (".py", ".cu", ".cuh", ".cc", ".c")]
    + [ROOT / s for s in SCRIPTS]
)


@pytest.fixture(scope="module")
def native_built():
    """The port's C++ tier, built once here (under its file lock) so the
    subprocess below only loads it."""
    from verifiable_mpc_tpu_torch import native

    assert native.available()


def test_import_and_enable_native_load_no_jax_or_reference(native_built):
    code = (
        "import sys\n"
        "import verifiable_mpc_tpu_torch as vm\n"
        "from verifiable_mpc_tpu_torch.ac20 import circuit_sat_cb, pivot_gpu\n"
        "from verifiable_mpc_tpu_torch.ops import msm_cuda, ntt\n"
        "from verifiable_mpc_tpu_torch.ops import curve_bn, field_bn254\n"
        "from verifiable_mpc_tpu_torch.ops import msm_bn_cuda\n"
        "from verifiable_mpc_tpu_torch.ops import curve_bn2, field_bn254x2\n"
        "from verifiable_mpc_tpu_torch.ops import msm_bn2_cuda\n"
        "from verifiable_mpc_tpu_torch.ops import (\n"
        "    add_cuda, limbs_mont, msm_bucket_cuda)\n"
        "from verifiable_mpc_tpu_torch.probes import (\n"
        "    probe_carrychain, probe_vpu)\n"
        "from verifiable_mpc_tpu_torch.tools import code_to_qap\n"
        "from verifiable_mpc_tpu_torch.trinocchio import (\n"
        "    pynocchio, qap_fast, trinocchio)\n"
        "assert vm.enable_native()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'verifiable_mpc_tpu'\n"
        "             or m.startswith('verifiable_mpc_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES]
)
def test_source_names_neither_jax_nor_the_reference(path):
    assert not _FORBIDDEN.search(path.read_text())


@pytest.mark.parametrize("device", [None, "cuda"])
def test_enable_gpu_without_a_card_raises(device):
    import torch

    import verifiable_mpc_tpu_torch as vm

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vm.enable_gpu(device)


@pytest.mark.parametrize("script", SCRIPTS)
def test_chip_script_fails_without_a_card(script, capsys, monkeypatch):
    """The script's main() returns non-zero and prints no result line when
    there is no card (run in this process: a child would spend seconds
    importing torch again)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.syspath_prepend(str(ROOT))
    spec = importlib.util.spec_from_file_location(script[:-3], ROOT / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rc = mod.main() if script == "chip_smoke.py" else mod.main([])
    assert rc != 0
    assert '"ok"' not in capsys.readouterr().out
