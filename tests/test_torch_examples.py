"""The port's examples (``qublas_tpu_torch/examples``) keep running on the
CPU, as subprocesses with a timeout, as ``tests/test_examples.py`` runs the
JAX package's; the ASIC datapath example prints the same GEMM output,
diagnostics and BitStream record lines as the JAX package's example for
the same seed.  The JAX example writes its checkpoint to a fixed name under
``/tmp``; here it runs with ``qublas_tpu.save``/``load`` pointed at a file
of the test's own directory, so no other run shares that file."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=env)


# run the JAX example as a script, its checkpoint (step 7) redirected to the
# file argv[1]
_JAX_EXAMPLE = """
import runpy, sys
import qublas_tpu as q
target, script = sys.argv[1:]
save, load = q.save, q.load
q.save = lambda path, tree: save(target, tree)
q.load = lambda path: load(target)
runpy.run_path(script, run_name="__main__")
"""


def _port(name, *args):
    return _run("-m", f"qublas_tpu_torch.examples.{name}", "--device", "cpu",
                *args)


def test_asic_datapath_example_matches_the_jax_example(tmp_path):
    ckpt = tmp_path / "datapath.npz"
    p = _port("asic_datapath_sim", "--checkpoint", str(ckpt))
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    assert ckpt.exists()
    assert "sharded over 2 rank(s) (gloo): bit-identical" in p.stdout
    jax_ckpt = tmp_path / "jax_datapath.npz"
    j = _run("-c", _JAX_EXAMPLE, str(jax_ckpt),
             str(ROOT / "examples" / "asic_datapath_sim.py"))
    assert j.returncode == 0, j.stdout[-2000:] + j.stderr[-2000:]
    assert jax_ckpt.exists()

    def lines(out):
        keep = ("GEMM out:", "requant act", "range report:",
                "with fused sqrt ROM:", "BitStream record:",
                "checkpoint round-trip")
        return [ln.replace(", device=cpu", "") for ln in out.splitlines()
                if ln.startswith(keep)]

    assert len(lines(p.stdout)) == 6
    assert lines(p.stdout) == lines(j.stdout)


def test_wide_formats_example():
    p = _port("wide_formats_and_sharding")
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    assert "sharded GEMM over {'dp': 1, 'tp': 2}: bit-exact = True" \
        in p.stdout
    assert "sharded qreduce bit-exact = True" in p.stdout
    assert "is_limb=True" in p.stdout and "is_pair=True" in p.stdout


def test_sharded_deployment_example(tmp_path):
    ckpt = tmp_path / "deployment.npz"
    p = _port("sharded_deployment", "--checkpoint", str(ckpt))
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    assert "sharded deployment example OK" in p.stdout
    assert ckpt.exists()
