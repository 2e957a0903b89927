"""The port never imports JAX or the JAX package, and its CUDA entry points
refuse to run without a GPU instead of falling back to the CPU.

Checked in a subprocess: tests/conftest.py imports jax into this process.
"""
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, os, pkgutil, sys
import torch
import longreadselfcorrect_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "longreadselfcorrect_tpu.")))
bad += [m for m in ("longreadselfcorrect_tpu",) if m in sys.modules]

# CUDA entry points raise when no GPU is present
raised = {}
from longreadselfcorrect_tpu_torch import cli
try:
    cli.main(["pbcorrect", "reads.fa", "-p", "missing", "-o", "out"])
except RuntimeError as e:
    raised["cli"] = str(e)
from longreadselfcorrect_tpu_torch.index.fmindex import FMIndex
import numpy as np
try:
    FMIndex.from_symbols(np.array([1, 2, 0], np.int8), 1, "cuda")
except (RuntimeError, AssertionError) as e:
    raised["fmindex"] = type(e).__name__
try:
    chip_smoke.phase_device()
except chip_smoke.PhaseError as e:
    raised["chip_smoke"] = str(e)
print(json.dumps({"n": len(mods), "mods": mods, "bad": bad, "raised": raised,
                  "cuda": torch.cuda.is_available(), "subcommands": subcommands(cli.main)}))
"""

SUBCOMMANDS = r"""
def subcommands(main):
    import contextlib, io, re
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            main(["--help"])
        except SystemExit:
            pass
    return re.search(r"\{([a-z,]+)\}", buf.getvalue()).group(1).split(",")
"""


def test_port_imports_no_jax_and_cuda_paths_raise(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", SUBCOMMANDS + PROBE], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], res["bad"]
    assert res["n"] >= 20, res["mods"]   # every module of the package was imported
    for m in ("cli", "ops.cuda", "ops.scan", "ops.seedscan", "ops.walk",
              "ops.msa_kernels", "core.msa", "core.batch_correct", "core.extend",
              "index.pack", "index.fmindex"):
        assert f"longreadselfcorrect_tpu_torch.{m}" in res["mods"]
    if not res["cuda"]:
        assert set(res["raised"]) == {"cli", "fmindex", "chip_smoke"}, res["raised"]
    # the port's CLI has every subcommand of the JAX CLI, in its order
    from longreadselfcorrect_tpu import cli as jcli

    scope = {}
    exec(SUBCOMMANDS, scope)
    want = scope["subcommands"](jcli.main)
    assert len(want) == 17 and res["subcommands"] == want, (res["subcommands"], want)


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    """No result line and a non-zero exit without CUDA, and alone in a
    directory without the package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = [subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                           cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=300)]
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    runs.append(subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                               capture_output=True, text=True, timeout=300))
    if torch.cuda.is_available():
        runs = runs[1:]
    for out in runs:
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
