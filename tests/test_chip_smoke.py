"""chip_smoke.py must refuse to run without a GPU: non-zero exit and no
result line, both here on the CPU and in a directory that holds the script
and nothing else of the repository."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(stdout):
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return False
        except ValueError:
            pass
    return True


def test_exits_nonzero_without_gpu():
    r = _run(ROOT, "chip_smoke.py")
    assert r.returncode != 0
    assert _no_result(r.stdout)
    assert "no GPU" in r.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert _no_result(r.stdout)
