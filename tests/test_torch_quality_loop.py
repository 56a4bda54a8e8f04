"""The port's mask-quality loop (``atlaspatch_tpu_torch/tools/quality_loop.sh``) on the CPU.

The script runs under ``bash`` with a stub ``python`` first on ``PATH``, as
``tests/test_torch_jobs.py`` runs the job scripts: the stub records its argv,
its working directory and its environment, and exits 0 (or 1 for a chosen
command). The JAX script, ``tools/quality_loop.sh``, runs under the same
stubs: the port's five steps hand their commands the same argv with only the
module names changed. Each recorded argv is parsed by the port's click
command (``make_context``: nothing runs) or by the corpus's argparse.

Then both packages' ``finetune-sam2`` run the loop's training options
(``--trainable all --lr-schedule cosine --augment``, a 15% hold-out, the
warmup cut to 2 steps for 4 steps in all) on a miniature corpus at
``SAM2Config.test_tiny`` from one init archive: per-step losses within 1e-4
relative, every trained tensor within 1e-4 of its largest value but for the
key biases (``torch_port_helpers.key_bias_mask``). The loop runs for real
on the card in ``chip_smoke.py``'s quality phase.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_port_helpers import CLI_PACKAGES, free_tmp_path, invoke_cli, key_bias_mask  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "atlaspatch_tpu_torch" / "tools" / "quality_loop.sh"
JAX_SCRIPT = REPO / "tools" / "quality_loop.sh"
STUB = """#!/bin/bash
log=$(mktemp "$STUB_LOG/call.XXXXXX")
echo "$log" >> "$STUB_LOG/order"
printf '%s\\0' "$@" > "$log"
printf '%s' "$0" > "$log.exe"
pwd > "$log.cwd"
env -0 > "$log.env"
for a in "$@"; do
  if [ "$a" = "$STUB_FAIL" ]; then exit 1; fi
done
"""
# variables a caller's environment may hold that would change what the script runs
CLEARED = ("PYTHON", "SEG_INPUT_SIZE", "EPOCHS", "ATLASPATCH_ALLOW_RANDOM_WEIGHTS", "STUB_FAIL")
PORT_MODULES = {"atlaspatch_tpu.cli": "atlaspatch_tpu_torch.cli",
                "atlaspatch_tpu.tools.synthetic_corpus": "atlaspatch_tpu_torch.tools.synthetic_corpus"}
STEPS = ["synthetic_corpus", "synthetic_corpus", "finetune-sam2", "detect-tissue", "detect-tissue",
         "evaluate-masks", "evaluate-masks"]


@pytest.fixture
def stubbed(tmp_path):
    bin_dir, log = tmp_path / "bin", tmp_path / "log"
    bin_dir.mkdir()
    log.mkdir()
    (bin_dir / "python").write_text(STUB)
    (bin_dir / "python").chmod(0o755)
    work = tmp_path / "qloop"

    def run(script: Path, **env: str):
        """Run ``script`` on ``work`` under the stub; (process, [(argv, cwd, env), ...] in call order);
        ``run.exes`` the stubs that ran, by path."""
        full = {k: v for k, v in os.environ.items() if k not in CLEARED}
        full.update(PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}", STUB_LOG=str(log), **{"STUB_FAIL": "", **env})
        for f in log.iterdir():
            f.unlink()
        proc = subprocess.run(["bash", str(script), str(work)], env=full, capture_output=True, text=True,
                              timeout=60)
        calls, run.exes = [], []
        order = log / "order"
        for f in map(Path, order.read_text().split() if order.exists() else []):
            argv = [a.decode() for a in f.read_bytes().split(b"\0")[:-1]]
            pairs = (kv.split("=", 1) for kv in Path(f"{f}.env").read_bytes().decode().split("\0") if "=" in kv)
            calls.append((argv, Path(f"{f}.cwd").read_text().strip(), dict(pairs)))
            run.exes.append(Path(f"{f}.exe").read_text())
        return proc, calls

    run.work, run.stub = work, bin_dir / "python"
    return run


def _step(argv: list[str]) -> str:
    assert argv[0] == "-m", argv
    return argv[1].rsplit(".", 1)[1] if argv[1].endswith("synthetic_corpus") else argv[2]


def _parse(argv: list[str]) -> dict:
    """The port's click command, or the corpus's argparse, on ``argv``, parsed but not run."""
    if argv[1] == "atlaspatch_tpu_torch.tools.synthetic_corpus":
        from atlaspatch_tpu_torch.tools import synthetic_corpus

        got = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sys, "argv", ["synthetic_corpus", *argv[2:]])
            mp.setattr(synthetic_corpus, "generate_corpus",
                       lambda out, **kw: got.update(out=out, **kw) or (out / "images", out / "masks"))
            synthetic_corpus.main()
        return got
    assert argv[1] == "atlaspatch_tpu_torch.cli", argv
    from atlaspatch_tpu_torch import cli

    command = cli.cli.commands[argv[2]]
    with command.make_context(argv[2], list(argv[3:])) as ctx:
        return dict(ctx.params)


def _make_inputs(work: Path) -> None:
    """The paths the commands take as existing, which the stub did not make."""
    for d in ("train/images", "train/masks", "eval/images", "eval/masks", "pred_trained/visualization",
              "pred_random/visualization", "run"):
        (work / d).mkdir(parents=True, exist_ok=True)
    (work / "run" / "sam2_finetuned.npz").write_bytes(b"")


def test_script_is_valid_bash_and_stands_alone():
    subprocess.run(["bash", "-n", str(SCRIPT)], check=True, timeout=30)
    text = SCRIPT.read_text()
    assert "set -ex" in text and "PY=${PYTHON:-python}" in text
    assert text.count('"$PY" -m atlaspatch_tpu_torch.') == 7
    commands = "".join(line for line in text.splitlines(keepends=True) if not line.lstrip().startswith("#"))
    assert "jax" not in text.lower() and "atlaspatch_tpu." not in text and "--device" not in commands


def test_five_steps_run_in_order_and_parse(stubbed):
    proc, calls = stubbed(SCRIPT)
    assert proc.returncode == 0, proc.stderr
    assert [_step(argv) for argv, _, _ in calls] == STEPS
    work = stubbed.work
    assert {cwd for _, cwd, _ in calls} == {str(REPO)}
    assert (work / "eval_mpp.csv").read_text().startswith("wsi,mpp\n")
    assert "=== TRAINED ===" in proc.stdout and "=== RANDOM BASELINE ===" in proc.stdout
    _make_inputs(work)
    parsed = [_parse(argv) for argv, _, _ in calls]
    train, evals, ft, trained, random, score_t, score_r = parsed
    assert (train["out"], train["n"], train["seed"]) == (work / "train", 96, 0)
    assert (evals["out"], evals["n"], evals["width"], evals["height"], evals["seed"], evals["prefix"]) == (
        work / "eval", 16, 4096, 3072, 5000, "ev")
    assert (ft["epochs"], ft["batch_size"], ft["trainable"], ft["learning_rate"], ft["image_size"]) == (
        20, 4, "all", 3e-4, 1024)
    assert (ft["lr_schedule"], ft["warmup_steps"], ft["val_fraction"], ft["augment"], ft["seed"], ft["verbose"]) == (
        "cosine", 30, 0.15, True, 0, True)
    assert ft["sam2_checkpoint"] is None and ft["output"] == str(work / "run")
    for detect, out in ((trained, "pred_trained"), (random, "pred_random")):
        assert (detect["seg_batch_size"], detect["seg_input_size"], detect["output"]) == (16, 1024, str(work / out))
        assert detect["mpp_csv"] == str(work / "eval_mpp.csv")
    assert trained["sam2_checkpoint"] == str(work / "run" / "sam2_finetuned.npz") and random["sam2_checkpoint"] is None
    for score, name in ((score_t, "trained"), (score_r, "random")):
        assert score["truth_dir"] == str(work / "eval" / "masks") and score["csv_path"] == str(work / f"{name}.csv")
    # every command on the default device, cuda; random weights only where the JAX script allows them
    assert {p["device"] for p in (ft, trained, random)} == {"cuda"}
    random_ok = [env.get("ATLASPATCH_ALLOW_RANDOM_WEIGHTS") for _, _, env in calls]
    assert random_ok == [None, None, "1", None, "1", None, None]


def test_passes_every_flag_of_the_jax_script(stubbed):
    proc, port = stubbed(SCRIPT)
    assert proc.returncode == 0, proc.stderr
    jax_proc, jax = stubbed(JAX_SCRIPT)
    assert jax_proc.returncode == 0, jax_proc.stderr
    assert len(port) == len(jax) == len(STEPS)
    for (argv, cwd, env), (want, want_cwd, want_env) in zip(port, jax):
        assert want[1] in PORT_MODULES, want
        assert argv == [want[0], PORT_MODULES[want[1]], *want[2:]]
        assert cwd == want_cwd == str(REPO)
        assert env.get("ATLASPATCH_ALLOW_RANDOM_WEIGHTS") == want_env.get("ATLASPATCH_ALLOW_RANDOM_WEIGHTS")


def test_the_two_knobs_reach_the_commands(stubbed):
    proc, calls = stubbed(SCRIPT, SEG_INPUT_SIZE="512", EPOCHS="3")
    assert proc.returncode == 0, proc.stderr
    _make_inputs(stubbed.work)
    _, _, ft, trained, random, _, _ = (_parse(argv) for argv, _, _ in calls)
    assert (ft["image_size"], ft["epochs"]) == (512, 3)
    assert trained["seg_input_size"] == random["seg_input_size"] == 512


def test_python_names_the_interpreter(stubbed, tmp_path):
    interp = tmp_path / "venv" / "python3"
    interp.parent.mkdir()
    interp.write_text(STUB)
    interp.chmod(0o755)
    proc, calls = stubbed(SCRIPT, PYTHON=str(interp))
    assert proc.returncode == 0, proc.stderr
    assert [_step(argv) for argv, _, _ in calls] == STEPS
    assert stubbed.exes == [str(interp)] * len(STEPS)
    stubbed(SCRIPT)
    assert stubbed.exes == [str(stubbed.stub)] * len(STEPS)


@pytest.mark.parametrize("failing,ran", [("finetune-sam2", 3), ("detect-tissue", 4), ("--n", 1)])
def test_stops_at_the_first_failing_step(stubbed, failing, ran):
    proc, calls = stubbed(SCRIPT, STUB_FAIL=failing)
    assert proc.returncode != 0
    assert [_step(argv) for argv, _, _ in calls] == STEPS[:ran]


def test_without_a_card_training_stops_naming_the_cpu_flag(stubbed, tmp_path):
    """The loop's finetune-sam2 argv through the real command: no card, no CPU fallback."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs")
    proc, calls = stubbed(SCRIPT)
    assert proc.returncode == 0, proc.stderr
    _make_inputs(stubbed.work)
    argv = calls[2][0]
    assert argv[2] == "finetune-sam2"
    result = invoke_cli("atlaspatch_tpu_torch", argv[2:])
    assert result.exit_code == 2 and "--device cpu" in result.output, result.output


def test_corpus_workers_write_the_same_files(tmp_path):
    """The loop's corpus step makes its pairs in worker processes: the same bytes as one process."""
    from atlaspatch_tpu_torch.tools.synthetic_corpus import generate_corpus

    for workers in (1, 3):
        generate_corpus(tmp_path / f"w{workers}", n=3, width=64, height=48, seed=4, prefix="q", workers=workers)
    files = sorted(p.relative_to(tmp_path / "w1") for p in (tmp_path / "w1").rglob("*.png"))
    assert len(files) == 6
    assert all((tmp_path / "w1" / p).read_bytes() == (tmp_path / "w3" / p).read_bytes() for p in files)


@pytest.mark.parametrize("width,height,seeds", [(160, 120, range(64)), (1024, 768, range(96, 98))])
def test_corpus_equals_the_jax_corpus(width, height, seeds):
    """The port computes each shape over the window it can reach: the same
    pixels and truth as the JAX generator's whole-grid passes, on seeds
    whose blobs, strokes and vacuoles reach past the frame."""
    from atlaspatch_tpu.tools import synthetic_corpus as jax_corpus
    from atlaspatch_tpu_torch.tools import synthetic_corpus

    for seed in seeds:
        got = synthetic_corpus.make_annotated_thumbnail(width, height, seed=seed)
        want = jax_corpus.make_annotated_thumbnail(width, height, seed=seed)
        assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes(), seed


# ------------------------------------------------------------------ both packages' training
LOOP_TRAIN_ARGS = ["--epochs", "2", "--batch-size", "4", "--trainable", "all", "--learning-rate", "3e-4",
                   "--lr-schedule", "cosine", "--warmup-steps", "2", "--val-fraction", "0.15", "--augment",
                   "--seed", "0", "--device", "cpu"]
LOOP_PAIRS = 10  # 2 held out at 0.15, 8 trained: 2 steps an epoch at batch 4


@pytest.fixture(scope="module")
def loop_finetunes(tmp_path_factory):
    """Both CLIs' finetune-sam2 with the loop's options over one miniature
    corpus from one init archive; per package its per-step losses, summary
    line and final archive."""
    import shutil

    from atlaspatch_tpu.tools.convert_weights import _flatten
    from atlaspatch_tpu_torch.tools.synthetic_corpus import generate_corpus
    from torch_port_helpers import CFG, shared_cli_weights, shared_flax_params

    tmp = tmp_path_factory.mktemp("loop_finetune")
    images, masks = generate_corpus(tmp / "corpus", n=LOOP_PAIRS, width=256, height=192)
    init = tmp / "init.npz"
    np.savez(init, **_flatten(shared_flax_params(0)))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        shared_cli_weights(mp, tmp)
        for pkg in CLI_PACKAGES:
            loop = __import__(f"{pkg}.models.train.loop", fromlist=["finetune_sam2"])
            losses, real = [], loop.finetune_sam2

            def recording(*a, on_step=None, _real=real, _losses=losses, **kw):
                def step(s, loss):
                    _losses.append(loss)
                    if on_step is not None:
                        on_step(s, loss)
                return _real(*a, on_step=step, **kw)

            mp.setattr(loop, "finetune_sam2", recording)
            out = tmp / f"ft-{pkg}"
            result = invoke_cli(pkg, ["finetune-sam2", images, "--masks", masks, "-o", out, *LOOP_TRAIN_ARGS,
                                      "--image-size", str(CFG.image_size), "--sam2-checkpoint", init],
                                catch_exceptions=False)
            assert result.exit_code == 0, result.output
            with np.load(out / "sam2_finetuned.npz") as z:
                runs[pkg] = dict(losses=losses, lines=result.stdout.splitlines(), npz={k: z[k] for k in z.files})
    with np.load(init) as z:
        runs["init"] = {k: z[k] for k in z.files}
    yield runs
    shutil.rmtree(tmp)


def test_loop_training_steps_match_jax(loop_finetunes):
    want, got = (loop_finetunes[p] for p in CLI_PACKAGES)
    assert len(got["losses"]) == len(want["losses"]) == 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert got["lines"][0].startswith("Finetuned 4 step(s) over 8 pair(s): loss ")
    assert got["lines"][1].startswith("Validation (2 held-out pair(s)): loss ")


def test_loop_training_archive_matches_jax(loop_finetunes):
    """Every tensor moved (--trainable all) and within 1e-4 of its largest
    value of JAX's, the key biases left out: their exact gradient is zero, so
    AdamW turns the round-off of either package into steps of ±lr."""
    want, got = (loop_finetunes[p]["npz"] for p in CLI_PACKAGES)
    init = loop_finetunes["init"]
    assert sorted(got) == sorted(want) == sorted(init)
    moved = [k for k in got if not np.array_equal(got[k], init[k])]
    assert len(moved) > 0.9 * len(got), f"{len(moved)} of {len(got)} tensors moved"
    worst, worst_key = 0.0, None
    for k in got:
        keep = ~key_bias_mask(k, got[k].shape)
        if keep.any():
            rel = float(np.abs(got[k] - want[k])[keep].max()) / max(float(np.abs(want[k])[keep].max()), 1e-30)
            worst, worst_key = max((worst, worst_key), (rel, k))
    print(f"port vs JAX after the loop's 4 steps: {worst:.3g} of {worst_key}'s largest")
    assert worst <= 1e-4, f"{worst_key} differs from JAX's by {worst} of its largest"


def test_the_loss_runs_in_the_params_dtype():
    """seg_forward casts the pixels to the params' dtype: a float64 model's
    gradient, which chip_smoke.py's quality phase holds float32 steps to,
    is float64 and, at the miniature config, within 1e-4 of each float32
    gradient's largest but for the key biases."""
    import torch

    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from atlaspatch_tpu_torch.models.sam2.model import init_params
    from atlaspatch_tpu_torch.models.train import finetune

    cfg = SAM2Config.test_tiny()
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, (2, cfg.image_size, cfg.image_size, 3), dtype=np.uint8))
    targets = torch.from_numpy((rng.random((2, cfg.image_size, cfg.image_size)) < 0.4).astype(np.float32))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = init_params(cfg, seed=1).to(dtype)
        params = finetune.trainable_parameters(model, "all")
        loss = finetune.seg_loss_fn(model, images, targets.to(dtype))
        loss.backward()
        assert loss.dtype == dtype
        grads[dtype] = {k: t.grad for k, t in params.items() if t.grad is not None}
    for k, g in grads[torch.float32].items():  # the key biases' exact gradient is zero: rounding noise either way
        keep = torch.from_numpy(~key_bias_mask(k, tuple(g.shape)))
        exact = grads[torch.float64][k]
        assert exact.dtype == torch.float64
        if keep.any():
            gap = float((g.double() - exact)[keep].abs().max())
            assert gap <= 1e-4 * float(exact[keep].abs().max()) + 1e-12, k


def test_detect_tissue_writes_a_trace_of_its_forwards(tmp_path, monkeypatch):
    """ATLASPATCH_TORCH_TRACE=<dir>: detect-tissue writes one trace with a
    sam2_forward span per batch, as chip_smoke.py's quality phase counts them."""
    from atlaspatch_tpu_torch.utils.perf import trace_counts
    from torch_port_helpers import shared_cli_weights, write_png_slides

    shared_cli_weights(monkeypatch, tmp_path)
    slides, csv = write_png_slides(tmp_path, {"s0": 0, "s1": 1, "s2": 2}, {"s0": 2.0, "s1": 2.0, "s2": 2.0})
    monkeypatch.setenv("ATLASPATCH_TORCH_TRACE", str(tmp_path / "trace"))
    result = invoke_cli("atlaspatch_tpu_torch", ["detect-tissue", slides, "--output", tmp_path / "out",
                                                  "--device", "cpu", "--seg-batch-size", "2", "--mpp-csv", csv])
    assert result.exit_code == 0 and "Created 3 mask overlay(s), failures: 0" in result.stdout, result.output
    (trace,) = (tmp_path / "trace").glob("trace-*.json")
    assert trace_counts(trace)["span:sam2_forward"] == 2
