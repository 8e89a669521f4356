"""The port's shell scripts (`scripts/torch_*.sh`, `scripts/torch_demo/*.sh`),
the counterparts of the JAX package's `scripts/*.sh` and
`scripts/demo/*.sh`:

  * `bash -n` passes on each of them, and every JAX shell script has its
    port;
  * every `python -m regione_tpu_torch.cli.main` line of the demos parses
    with the port's `make_parser()`, with the dataset-path checks of
    tests/test_cli.py::test_demo_scripts_parse_against_real_cli, runs on
    `--device cuda`, and keeps the JAX line's flags otherwise (a Qwen demo
    drops `--int4`: memplan says bf16 fits one H100);
  * `torch_run_minibench.sh --mock --device cpu` runs to its end on the CPU
    (tiny preset: the generation, pixel metrics, merge and VIEScore with the
    dry-run backbone), and `--mock` without `--device cpu` stops (the tiny
    preset's head_dim 16 does not run on the card).
"""

import os
import re
import shlex
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_SCRIPTS = sorted((REPO / "scripts").glob("torch_*.sh")) + sorted(
    (REPO / "scripts" / "torch_demo").glob("*.sh"))


@pytest.mark.parametrize("path", PORT_SCRIPTS,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_bash_n(path):
    res = subprocess.run(["bash", "-n", str(path)], capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr


def test_every_jax_shell_script_has_its_port():
    names = {p.name for p in PORT_SCRIPTS}
    for sh in ("run_minibench.sh", "evaluation.sh", "bench_all_backends.sh"):
        assert "torch_" + sh in names
    demos = sorted(p.name for p in (REPO / "scripts" / "demo").glob("*.sh"))
    assert len(demos) == 5
    assert demos == sorted(p.name for p in
                           (REPO / "scripts" / "torch_demo").glob("*.sh"))


def _cli_lines(path, module):
    joined = re.sub(r"\\\s*\n", " ", path.read_text())
    return [shlex.split(line.strip())[3:] for line in joined.splitlines()
            if line.strip().startswith(f"python -m {module}")]


@pytest.mark.parametrize("name", sorted(
    p.name for p in (REPO / "scripts" / "torch_demo").glob("*.sh")))
def test_demo_lines_parse_with_the_port_cli(name):
    from regione_tpu_torch.cli import main as cli
    parser = cli.make_parser()
    port = _cli_lines(REPO / "scripts" / "torch_demo" / name,
                      "regione_tpu_torch.cli.main")
    jax = _cli_lines(REPO / "scripts" / "demo" / name, "regione_tpu.cli.main")
    assert len(port) == len(jax) >= 2
    for argv, jargv in zip(port, jax):
        args = parser.parse_args(argv)       # SystemExit on an unknown flag
        assert args.device == "cuda"
        if args.evaluation:
            root = Path(args.image_path or args.eval_dir)
            assert root.parts[-2] == "Processed"
            assert root.parts[-1] in ("GEdit-Bench", "Kontext-Bench")
        elif args.image_path and args.image_path.endswith(".jsonl"):
            assert (REPO / args.image_path).exists()
        want = ["cuda" if a == "tpu" else a for a in jargv]
        if args.backend.startswith("qwen"):
            want = [a for a in want if a != "--int4"]
        assert argv == want


def _run(argv, **kw):
    env = dict(os.environ, PYTHON=sys.executable,
               PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    return subprocess.run(["bash", str(REPO / "scripts" /
                                       "torch_run_minibench.sh"), *argv],
                          capture_output=True, text=True, env=env,
                          timeout=300, **kw)


def test_minibench_mock_runs_on_the_cpu(tmp_path):
    out = tmp_path / "mb"
    res = _run([str(out), "--mock", "--device", "cpu"])
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "minibench sweep complete" in res.stdout
    tasks = sorted(p.name for p in (REPO / "assets" / "minibench").iterdir()
                   if p.is_dir())
    for task in tasks:
        assert list((out / "regione" / task / "generation").glob("*.png"))
        for name in ("metric.csv", "dryrun_vie_score.csv"):
            assert (out / "regione" / task / name).exists()
    assert (out / "regione" / "merged_metric.txt").exists()
    stop = _run([str(tmp_path / "no"), "--mock"])
    assert stop.returncode == 2 and "--device cpu" in stop.stderr
