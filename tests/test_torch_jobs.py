"""The port's launch scripts (``jobs/atlaspatch_tpu_torch_*.sh``) on the CPU.

Each script runs under ``bash`` with stub ``python``, ``srun``, ``torchrun``,
``scontrol`` and ``gcloud`` first on ``PATH``: each stub writes its argv
(NUL-separated) and environment to a file, ``srun`` then runs its arguments
and ``scontrol`` prints two host names. The command line a script hands the
port's CLI is parsed by the port's click commands (``make_context``, nothing
runs), torchrun's by torchrun's own parser, and the JAX scripts run under the
same stubs to give the flags each port script must pass with the same values
(``--device tpu`` becomes ``cuda``). No SAM2 runs here; the scripts run on
the card in ``chip_smoke.py``'s jobs phase.
"""

from __future__ import annotations

import json
import os
import shlex
import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JOBS = REPO / "jobs"
PATCH = JOBS / "atlaspatch_tpu_torch_patch.slurm.sh"
FEATURES = JOBS / "atlaspatch_tpu_torch_features.slurm.sh"
MULTINODE = JOBS / "atlaspatch_tpu_torch_multinode.slurm.sh"
PORT_SCRIPTS = (PATCH, FEATURES, MULTINODE)
# each port script beside the JAX script it stands for
COUNTERPARTS = {PATCH: "atlaspatch_tpu_patch.slurm.sh", FEATURES: "atlaspatch_tpu_features.slurm.sh",
                MULTINODE: "atlaspatch_tpu_pod.sh"}

RECORD = """#!/bin/bash
log=$(mktemp "$STUB_LOG/$(basename "$0").XXXXXX")
printf '%s\\0' "$@" > "$log"
env -0 > "$log.env"
"""
STUBS = {
    "python": RECORD,
    "torchrun": RECORD,
    "gcloud": RECORD,
    "srun": RECORD + 'exec "$@"\n',
    "scontrol": RECORD + "printf 'gpu-node-a\\ngpu-node-b\\n'\n",
}
# variables a caller's environment may hold that would change what the scripts pass
CLEARED = ("PYTHON", "G", "RDZV_PORT", "PATCH_SIZE", "TARGET_MAG", "EXTRACTORS", "ATLASPATCH_NUM_HOSTS",
           "ATLASPATCH_HOST_ID")


@pytest.fixture
def stubs(tmp_path):
    bin_dir, log = tmp_path / "bin", tmp_path / "log"
    bin_dir.mkdir()
    log.mkdir()
    for name, body in STUBS.items():
        (bin_dir / name).write_text(body)
        (bin_dir / name).chmod(0o755)
    wsi, out = tmp_path / "slides", tmp_path / "out"
    wsi.mkdir()

    def run(script: Path, *extra: str, **env: str) -> dict[str, list]:
        """Run ``script`` under the stubs; {stub: [(argv, env), ...]}."""
        full = {k: v for k, v in os.environ.items() if k not in CLEARED and not k.startswith("SLURM_")}
        full.update(PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}", STUB_LOG=str(log), WSI_DIR=str(wsi),
                    OUT_DIR=str(out), TPU_NAME="pod", ZONE="zone-a", **env)
        for f in log.iterdir():
            f.unlink()
        proc = subprocess.run(["bash", str(script), *extra], env=full, capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
        calls: dict[str, list] = {}
        for f in sorted(log.iterdir()):
            if f.suffix == ".env":
                continue
            argv = f.read_bytes().split(b"\0")[:-1]
            pairs = (kv.split("=", 1) for kv in Path(f"{f}.env").read_bytes().decode().split("\0") if "=" in kv)
            calls.setdefault(f.name.split(".")[0], []).append(([a.decode() for a in argv], dict(pairs)))
        return calls

    run.wsi, run.out = wsi, out
    return run


def _flags(tokens: list[str]) -> dict[str, str | None]:
    """``--flag value`` / ``--flag`` tokens of a command line as {flag: value or None}."""
    flags = {}
    for i, tok in enumerate(tokens):
        if tok.startswith("--"):
            nxt = tokens[i + 1] if i + 1 < len(tokens) else None
            flags[tok] = None if nxt is None or nxt.startswith("--") else nxt
    return flags


def _cli_argv(calls: dict[str, list]) -> list[str]:
    """The one ``python -m atlaspatch_tpu_torch.cli`` command a SLURM script ran."""
    ((argv, _),) = calls["python"]
    assert argv[:2] == ["-m", "atlaspatch_tpu_torch.cli"], argv
    return argv[2:]


def _parse(argv: list[str]) -> dict:
    """The port's click command for ``argv[0]``, parsed (callbacks and all) but not run."""
    from atlaspatch_tpu_torch import cli

    command = cli.cli.commands[argv[0]]
    with command.make_context(argv[0], list(argv[1:])) as ctx:
        return dict(ctx.params)


def _jax_flags(stubs, script: str) -> dict[str, str | None]:
    """The flags the JAX script passes its CLI, with the slide directory and
    the output as the port script gets them."""
    calls = stubs(JOBS / script)
    if "gcloud" in calls:  # the pod script: the CLI command inside the ssh --command string
        ((argv, _),) = calls["gcloud"]
        command = argv[argv.index("--command") + 1]
        tokens = shlex.split(command.split("python -m atlaspatch_tpu.cli", 1)[1])
    else:
        ((argv, _),) = calls["python"]
        assert argv[:2] == ["-m", "atlaspatch_tpu.cli"], argv
        tokens = argv[2:]
    flags = _flags(tokens)
    assert flags.pop("--device") == "tpu"
    return {**flags, "--device": "cuda"}


def _torchrun(calls: dict[str, list]):
    """srun → torchrun, parsed by torchrun's own parser; (torchrun args, CLI argv)."""
    from torch.distributed.run import get_args_parser

    ((srun_argv, _),) = calls["srun"]
    ((argv, _),) = calls["torchrun"]
    assert srun_argv == ["torchrun", *argv]
    args = get_args_parser().parse_args(argv)
    assert args.no_python and args.training_script_args[:2] == ["-m", "atlaspatch_tpu_torch.cli"]
    return args, args.training_script_args[2:]


@pytest.mark.parametrize("script", PORT_SCRIPTS, ids=lambda p: p.name)
def test_script_is_valid_bash_and_stands_alone(script):
    subprocess.run(["bash", "-n", str(script)], check=True, timeout=30)
    text = script.read_text()
    assert "set -euo pipefail" in text and '"${PYTHON:-python}" -m atlaspatch_tpu_torch.cli' in text
    assert "jax" not in text.lower() and "atlaspatch_tpu.cli" not in text and "gcloud" not in text
    assert "--device cuda" in text and "--device cpu" not in text


@pytest.mark.parametrize("script", PORT_SCRIPTS, ids=lambda p: p.name)
def test_script_passes_every_flag_of_its_jax_counterpart(stubs, script):
    env = {"SLURM_NNODES": "1", "SLURM_JOB_NODELIST": "gpu-node-a", "SLURM_JOB_ID": "7"}
    calls = stubs(script, **env)
    argv = _torchrun(calls)[1] if script is MULTINODE else _cli_argv(calls)
    want = _jax_flags(stubs, COUNTERPARTS[script])
    got = _flags(argv)
    assert {k: got.get(k, "absent") for k in want} == want
    params = _parse(argv)
    assert params["device"] == "cuda" and params["skip_existing"] is True
    assert Path(params["wsi_path"]) == stubs.wsi and Path(params["output"]) == stubs.out
    if script is FEATURES:
        assert params["feature_extractors"] == "uni_v1" and params["feature_precision"] == "float16"


@pytest.mark.parametrize("gpus", [None, "1", "2", "8"])
@pytest.mark.parametrize("script,flag,param,on,off", [
    (PATCH, "--seg-data-parallel", "seg_data_parallel", True, False),
    (FEATURES, "--feature-parallel", "feature_parallel", "data", "none"),
], ids=["patch", "features"])
def test_parallel_flags_follow_the_node_cards(stubs, gpus, script, flag, param, on, off):
    calls = stubs(script, **({} if gpus is None else {"SLURM_GPUS_ON_NODE": gpus}))
    argv = _cli_argv(calls)
    many = gpus is not None and int(gpus) > 1
    assert (flag in argv) == many
    assert _parse(argv)[param] == (on if many else off)


def test_patch_script_reads_the_allocation(stubs):
    params = _parse(_cli_argv(stubs(PATCH, SLURM_CPUS_PER_TASK="4")))
    assert params["patch_workers"] == 4 and params["seg_batch_size"] == 32 and params["max_open_slides"] == 200
    assert _parse(_cli_argv(stubs(PATCH)))["patch_workers"] == 8
    features = _parse(_cli_argv(stubs(FEATURES, EXTRACTORS="uni_v1 conch_v1")))
    assert features["feature_extractors"] == "uni_v1 conch_v1" and features["feature_batch_size"] == 64


def test_multinode_hands_torchrun_the_allocation_and_extra_flags(stubs, tmp_path):
    spaced = tmp_path / "a dir with spaces"
    spaced.mkdir()
    (spaced / "mpp.csv").write_text("wsi,mpp\n")
    extra = ["--seg-input-size", "1024", "--mpp-csv", str(spaced / "mpp.csv"), "--verbose"]
    calls = stubs(MULTINODE, *extra, SLURM_NNODES="2", SLURM_JOB_NODELIST="gpu-node-[a-b]", SLURM_JOB_ID="4242",
                  SLURM_GPUS_ON_NODE="4", PYTHON="/srv/atlas-env/bin/python3")
    ((scontrol_argv, _),) = calls["scontrol"]
    assert scontrol_argv == ["show", "hostnames", "gpu-node-[a-b]"]
    args, argv = _torchrun(calls)
    assert (args.nnodes, args.nproc_per_node) == ("2", "4")
    assert (args.rdzv_backend, args.rdzv_endpoint, args.rdzv_id) == ("c10d", "gpu-node-a:29500", "4242")
    assert args.training_script == "/srv/atlas-env/bin/python3"
    assert argv[0] == "segment-and-get-coords" and argv[-len(extra):] == extra
    params = _parse(argv)
    assert params["mpp_csv"] == str(spaced / "mpp.csv") and params["seg_input_size"] == 1024
    assert params["fast"] and params["verbose"] and params["device"] == "cuda" and params["seg_batch_size"] == 32
    # the ranks per node and the rendezvous port can be set; the ranks read the group, not the environment
    calls = stubs(MULTINODE, SLURM_NNODES="1", SLURM_JOB_NODELIST="gpu-node-a", SLURM_JOB_ID="1", G="2",
                  RDZV_PORT="29611")
    args, _ = _torchrun(calls)
    assert (args.nnodes, args.nproc_per_node, args.rdzv_endpoint) == ("1", "2", "gpu-node-a:29611")
    assert args.training_script == "python"
    (_, torchrun_env), = calls["torchrun"]
    assert "ATLASPATCH_NUM_HOSTS" not in torchrun_env and "ATLASPATCH_HOST_ID" not in torchrun_env


@pytest.mark.parametrize("script,missing", [
    (PATCH, "WSI_DIR"), (FEATURES, "OUT_DIR"), (MULTINODE, "SLURM_NNODES"), (MULTINODE, "SLURM_JOB_NODELIST"),
])
def test_script_stops_before_any_launch_without_its_inputs(stubs, tmp_path, script, missing):
    env = {k: v for k, v in os.environ.items() if k not in CLEARED and not k.startswith("SLURM_")}
    log = tmp_path / "log"
    env.update(PATH=f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}", STUB_LOG=str(log),
               WSI_DIR=str(stubs.wsi), OUT_DIR=str(stubs.out), SLURM_NNODES="1", SLURM_JOB_NODELIST="gpu-node-a",
               SLURM_JOB_ID="1")
    del env[missing]
    proc = subprocess.run(["bash", str(script)], env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0 and missing in proc.stderr
    assert not [f for f in log.iterdir() if f.name.split(".")[0] in ("python", "srun", "torchrun")]


def test_a_trace_counts_the_forwards_of_its_run(tmp_path, monkeypatch):
    """``maybe_trace``'s Chrome trace holds one ``sam2_forward`` span per SAM2
    forward and one ``embed_forward`` span per encoder forward, those the
    engine dispatches from its worker thread included, counted by
    ``perf.trace_counts`` (how the jobs phase counts a script process's
    forwards). They are the recorder's spans, merged into the trace, never
    the profiler's own annotations. A stand-in SAM2 module and a one-layer
    encoder keep it cheap."""
    import numpy as np
    import torch

    from atlaspatch_tpu_torch.models.encoders.engine import TorchFeatureExtractor
    from atlaspatch_tpu_torch.models.encoders.zoo import ENTRIES
    from atlaspatch_tpu_torch.models.sam2 import model as sam2_model
    from atlaspatch_tpu_torch.utils import perf

    class Masks(torch.nn.Module):
        cfg = type("Cfg", (), {"image_size": 32})()

        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(()))

        def forward(self, pixels, boxes, multimask_output):
            return torch.zeros(pixels.shape[0], 1, 1, 8, 8) * self.w, None, None

    class Pooled(torch.nn.Module):  # (N, S, S, 3) → (N, 4)
        def __init__(self):
            super().__init__()
            self.proj = torch.nn.Linear(3, 4)

        def forward(self, x):
            return self.proj(x.mean(dim=(1, 2)))

    spec = ENTRIES["resnet50"].preprocess
    encoder = TorchFeatureExtractor(name="tiny", embedding_dim=4, spec=spec, device="cpu", model=Pooled())
    monkeypatch.setenv("ATLASPATCH_TORCH_TRACE", str(tmp_path / "trace"))
    try:
        with perf.maybe_trace():
            for b in (1, 2, 4):
                sam2_model._full_frame_logits(Masks(), torch.zeros(b, 32, 32, 3))
            encoder.forward_device(torch.zeros(2, spec.crop, spec.crop, 3, dtype=torch.uint8))
            rows = encoder.extract_batch([np.zeros((64, 64, 3), np.uint8)] * 3)  # forwards on the dispatch thread
        # outside maybe_trace no span is recorded: another profiler's device-time
        # totals (chip_smoke.py's busy shares) would count a span's device-side copy
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            sam2_model._full_frame_logits(Masks(), torch.zeros(1, 32, 32, 3))
            encoder.forward_device(torch.zeros(1, spec.crop, spec.crop, 3, dtype=torch.uint8))
    finally:
        encoder.cleanup()
    assert rows.shape == (3, 4)
    (trace,) = (tmp_path / "trace").glob("trace-*.json")
    # no card here, so no kernel; the engine's other spans besides
    counts = perf.trace_counts(trace)
    assert counts["span:sam2_forward"] == 3 and counts["span:embed_forward"] == 2
    assert not [k for k in counts if k.startswith("kernel:")]
    events = json.loads(trace.read_text())["traceEvents"]
    assert not [e for e in events if e.get("cat") == "user_annotation"
                and e["name"] in ("sam2_forward", "embed_forward")]
    assert not {e.name for e in prof.events()} & {"sam2_forward", "embed_forward"}
