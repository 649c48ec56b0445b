"""chip_smoke.py outside its card: it must refuse, and its options must pick
the phases they name.  (On a card: ``python chip_smoke.py``.)"""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("where", ["cpu_backend", "script_alone"])
def test_refuses_without_card_or_repo(where, tmp_path):
    """Exit code non-zero and no result line: on a CPU-only backend, and
    when the script sits in a directory without the rest of the repo."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "script_alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert ("no GPU" if where == "cpu_backend"
            else "ModuleNotFoundError") in proc.stderr


def test_four_gpus_selects_only_its_phase():
    names = [n for n, _ in chip_smoke.select_phases(
        chip_smoke.parse_args(["--four-gpus"]))]
    assert names == ["four_gpus"]
    names = [n for n, _ in chip_smoke.select_phases(chip_smoke.parse_args([]))]
    assert names == ["kernel", "api", "driver"]
