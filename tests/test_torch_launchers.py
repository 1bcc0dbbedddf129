"""The port's launcher scripts against the JAX package's (`scripts/*.sh`).

Each launcher runs under bash with a stub `python` first on PATH that records
its arguments: the port's must pass the JAX launcher's preset flags, with
`python scripts/<x>.py` read as `python -m dynamicrafter_tpu_torch.<x>`, and
pass extra flags through last.
"""
import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STUB = """#!/bin/bash
for a in "$@"; do printf '%s\\n' "$a"; done > "$ARGV_OUT"
"""

# (launcher, positional arguments given to the JAX one and to the port's)
CASES = [
    ("run.sh", ["256"]), ("run.sh", ["512"]), ("run.sh", ["1024"]),
    ("run_fixed.sh", ["256"]), ("run_fixed.sh", ["512"]), ("run_fixed.sh", ["1024"]),
    ("run_fixed.sh", ["512", "my.ckpt", "my_prompts"]),
    ("run_application.sh", ["interp"]), ("run_application.sh", ["loop"]),
    ("run_application.sh", ["loop", "m.ckpt", "p"]),
    ("run_mp.sh", ["512"]), ("run_mp.sh", ["256"]),
    ("run_interp.sh", []), ("run_interp.sh", ["save_here"]),
    ("run_guidance.sh", ["256"]), ("run_guidance.sh", ["512"]),
]
EXTRA = {"run_interp.sh": 1}  # positional arguments before the extra flags; 3 elsewhere


def _run(script, args, tmp_path, env_extra=None):
    stub_dir = tmp_path / "bin"
    stub_dir.mkdir(exist_ok=True)
    stub = stub_dir / "python"
    stub.write_text(STUB)
    stub.chmod(0o755)
    out = tmp_path / "argv.txt"
    env = dict(os.environ, PATH=f"{stub_dir}:{os.environ['PATH']}", ARGV_OUT=str(out),
               **(env_extra or {}))
    proc = subprocess.run(["bash", os.path.join(REPO, script), *args], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    return out.read_text().splitlines()


def _entry(argv):
    """(module, the rest): `scripts/x.py` and `-m dynamicrafter_tpu_torch.x` read alike."""
    if argv[0] == "-m":
        return argv[1].rsplit(".", 1)[-1], argv[2:]
    return os.path.splitext(os.path.basename(argv[0]))[0], argv[1:]


@pytest.mark.parametrize("script,args", CASES,
                         ids=[f"{s}-{'-'.join(a) or 'default'}" for s, a in CASES])
def test_port_launcher_passes_the_jax_presets(script, args, tmp_path):
    env = {"NUM_PROCESSES": "2", "PROCESS_ID": "1", "COORDINATOR": "host:1234"}
    jax_argv = _run(os.path.join("scripts", script), args, tmp_path, env)
    port_argv = _run(os.path.join("dynamicrafter_tpu_torch", script), args, tmp_path, env)
    assert port_argv[:2] == ["-m", "dynamicrafter_tpu_torch." + _entry(jax_argv)[0]]
    assert _entry(port_argv) == _entry(jax_argv)


@pytest.mark.parametrize("script", sorted({s for s, _ in CASES}))
def test_extra_flags_come_through_last(script, tmp_path):
    n = EXTRA.get(script, 3)
    first = {"run_application.sh": "interp", "run_interp.sh": str(tmp_path / "runs")}.get(
        script, "512")
    positional = [first, "c.ckpt", "pdir"][:n]
    argv = _run(os.path.join("dynamicrafter_tpu_torch", script),
                [*positional, "--random_init", "--ddim_steps", "4"], tmp_path)
    assert argv[-3:] == ["--random_init", "--ddim_steps", "4"]
    if script == "run_interp.sh":
        assert (tmp_path / "runs" / "training_512_interp").is_dir()
    else:
        assert argv[argv.index("--ckpt_path") + 1] == "c.ckpt"
        assert argv[argv.index("--prompt_dir") + 1] == "pdir"


@pytest.mark.parametrize("script", sorted({s for s, _ in CASES}))
def test_launcher_parses(script):
    for path in (os.path.join("scripts", script), os.path.join("dynamicrafter_tpu_torch", script)):
        proc = subprocess.run(["bash", "-n", os.path.join(REPO, path)], capture_output=True,
                              text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
