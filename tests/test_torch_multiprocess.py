"""The port's multi-process paths: two ranks of a ``torch.distributed`` group
on gloo, each a fresh Python process that imports no JAX, against one
process of the port and the JAX package's loop.

Each rank gets torchrun's variables (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` on a
free port) and joins through ``multihost.maybe_init_distributed("cpu")``,
which picks gloo. The miniature SAM2 (``test_tiny``) runs at 64 px from one
init archive, as tests/test_multihost_finetune.py runs the JAX loop:

  * fine-tuning (4 pairs, ``val_fraction`` 0.25, ``augment``, ``trainable
    all``): the ranks' losses agree to 1e-5; losses, val loss and IoU match
    the one-process port and JAX's ``finetune_sam2`` at rtol 2e-3; only
    rank 0 writes ``sam2_finetuned.npz``;
  * resume: two ranks resume rank 0's step checkpoint and reproduce the
    uninterrupted two-rank run (losses to 1e-5, final weights < 1e-6);
  * a save that fails on rank 0 raises its own OSError there (chained) and a
    RuntimeError naming rank 0 on rank 1, with no hang;
  * ``segment-and-get-coords`` from two ranks (no ATLASPATCH_NUM_HOSTS) over
    one output directory: slides shard over the ranks, every H5 equals a
    one-process run's, each slide is processed once, no lock is left.

Every subprocess is waited for with a timeout and killed on it.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from atlaspatch_tpu.models.sam2.config import SAM2Config as JaxSAM2Config
from atlaspatch_tpu.models.train import loop as jax_loop
from atlaspatch_tpu.tools.convert_weights import _flatten
from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
from atlaspatch_tpu_torch.models.train import loop
from torch_port_helpers import free_tmp_path, shared_flax_params  # noqa: F401 (free_tmp_path: autouse)

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 240  # seconds per rank; a run takes ~10

FINETUNE = dict(epochs=2, batch_size=2, image_size=64, device="cpu", seed=0, learning_rate=1e-3, trainable="all",
                augment=True)

WORKER = r"""
import json, os, sys
args = json.loads(sys.argv[1])
from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
SAM2Config.tiny = SAM2Config.test_tiny
from atlaspatch_tpu_torch.models.train import checkpoints, loop
from atlaspatch_tpu_torch.parallel import multihost

rank = int(os.environ["RANK"])
if args.pop("fail_save") and rank == 0:
    def full_disk(*_a, **_k):
        raise OSError(28, "No space left on device")
    checkpoints.save_checkpoint = full_disk
out = {"initialized": multihost.maybe_init_distributed("cpu")}
out["host"] = list(multihost.host_identity())
out["backend"] = __import__("torch.distributed").distributed.get_backend()
losses = []
try:
    summary = loop.finetune_sam2(args.pop("images"), args.pop("masks"), args.pop("out").format(rank=rank),
                                 on_step=lambda step, loss: losses.append(loss), **args)
    out.update(losses=losses, summary=summary)
except Exception as e:
    out.update(error=type(e).__name__, message=str(e), cause=repr(e.__cause__))
    raise
finally:
    multihost.shutdown_distributed()
    out["jax"] = any(m == "jax" or m.startswith(("jax.", "flax", "atlaspatch_tpu.")) for m in sys.modules)
    tmp = os.environ["RESULT"] + ".tmp"
    with open(tmp, "w") as f:
        json.dump(out, f)
    os.replace(tmp, os.environ["RESULT"])
"""

CLI_WORKER = r"""
import sys
from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
SAM2Config.tiny = SAM2Config.test_tiny
from atlaspatch_tpu_torch.cli import main
main(sys.argv[1:])
assert not any(m == "jax" or m.startswith(("jax.", "flax", "atlaspatch_tpu.")) for m in sys.modules)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(rank: int, port: int, **extra) -> dict:
    env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
               MASTER_ADDR="localhost", MASTER_PORT=str(port), PYTHONPATH=str(REPO), OMP_NUM_THREADS="2",
               ATLASPATCH_ALLOW_RANDOM_WEIGHTS="1", **extra)
    for var in ("ATLASPATCH_NUM_HOSTS", "ATLASPATCH_HOST_ID", "XLA_FLAGS"):
        env.pop(var, None)
    return env


def _start(code: str, argv: list, envs: list[dict]) -> list[subprocess.Popen]:
    return [subprocess.Popen([sys.executable, "-c", code, *argv], env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for env in envs]


def _wait(procs: list[subprocess.Popen]) -> list[tuple[int, str]]:
    """(exit code, output) of each process, each waited for with TIMEOUT and
    killed on it (which fails the test)."""
    done = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            pytest.fail(f"a rank hung past {TIMEOUT} s:\n{out[-3000:]}")
        done.append((p.returncode, out))
    return done


def _ranks(tmp: Path, tag: str, fail_save: bool = False, **kw) -> list[subprocess.Popen]:
    port = _free_port()
    envs = [_env(r, port, RESULT=str(tmp / f"{tag}{r}.json")) for r in range(2)]
    return _start(WORKER, [json.dumps(dict(kw, fail_save=fail_save))], envs)


def _results(tmp: Path, tag: str, done) -> list[dict]:
    out = []
    for r, (rc, log) in enumerate(done):
        assert (tmp / f"{tag}{r}.json").exists(), f"rank {r} left no result (rc {rc}):\n{log[-3000:]}"
        res = json.loads((tmp / f"{tag}{r}.json").read_text())
        assert res["initialized"] and res["backend"] == "gloo" and res["host"] == [r, 2], res
        assert not res["jax"], f"rank {r} imported JAX"
        out.append((rc, log, res))
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """4 pairs of 64x64 (tests/test_multihost_finetune.py's) and one init
    archive of the miniature SAM2."""
    root = tmp_path_factory.mktemp("mp")
    rng = np.random.default_rng(11)
    images, masks = root / "images", root / "masks"
    images.mkdir()
    masks.mkdir()
    for i in range(4):
        img = rng.uniform(200, 255, (64, 64, 3)).astype(np.uint8)
        yy, xx = np.mgrid[0:64, 0:64]
        cx, cy = rng.integers(16, 48, 2)
        blob = (xx - cx) ** 2 + (yy - cy) ** 2 < 14**2
        img[blob] = (180, 110, 170)
        Image.fromarray(img).save(images / f"s{i}.png")
        Image.fromarray((blob * 255).astype(np.uint8)).save(masks / f"s{i}_mask.png")
    init = root / "init.npz"
    np.savez(init, **_flatten(shared_flax_params(0)))
    yield dict(images=str(images), masks=str(masks), checkpoint=str(init))
    import shutil

    shutil.rmtree(root, ignore_errors=True)


def test_two_ranks_finetune_matches_one_process_and_jax(data, tmp_path, monkeypatch):
    # each rank writes into a directory of its own: rank 1 must write nothing into its own
    procs = _ranks(tmp_path, "mp", out=str(tmp_path / "mp{rank}"), val_fraction=0.25, **data, **FINETUNE)
    monkeypatch.setattr(SAM2Config, "tiny", SAM2Config.test_tiny)
    monkeypatch.setattr(JaxSAM2Config, "tiny", JaxSAM2Config.test_tiny)
    common = dict(val_fraction=0.25, checkpoint=Path(data["checkpoint"]), **FINETUNE)
    runs = {}
    for name, package in (("port", loop), ("jax", jax_loop)):
        losses = []
        summary = package.finetune_sam2(data["images"], data["masks"], tmp_path / name,
                                        on_step=lambda s, loss, out=losses: out.append(float(loss)), **common)
        runs[name] = (losses, summary)
    (rc0, log0, r0), (rc1, log1, r1) = _results(tmp_path, "mp", _wait(procs))
    assert rc0 == rc1 == 0, log0[-2000:] + log1[-2000:]
    # 4 pairs, 1 held out: 1 step per epoch, 2 epochs
    assert r0["summary"]["steps"] == r1["summary"]["steps"] == runs["port"][1]["steps"] == 2
    np.testing.assert_allclose(r0["losses"], r1["losses"], rtol=1e-5)
    np.testing.assert_allclose(r0["summary"]["val_loss"], r1["summary"]["val_loss"], rtol=1e-5)
    for name, (losses, summary) in runs.items():
        np.testing.assert_allclose(r0["losses"], losses, rtol=2e-3, err_msg=name)
        np.testing.assert_allclose([r0["summary"]["val_loss"], r0["summary"]["val_iou"]],
                                   [summary["val_loss"], summary["val_iou"]], rtol=2e-3, err_msg=name)
    assert sorted(p.name for p in (tmp_path / "mp0").iterdir()) == ["sam2_finetuned.npz"]
    assert not list((tmp_path / "mp1").iterdir())


def test_two_ranks_resume_reproduces_the_uninterrupted_run(data, tmp_path):
    common = dict(**data, **dict(FINETUNE, save_every=1))
    full = _ranks(tmp_path, "full", out=str(tmp_path / "full"), **common)
    leg1 = _ranks(tmp_path, "leg1_", out=str(tmp_path / "res"), **dict(common, epochs=1))
    full0, full1 = (res for _, _, res in _results(tmp_path, "full", _wait(full)))
    _results(tmp_path, "leg1_", _wait(leg1))
    assert full0["summary"]["steps"] == 4
    # one writer, one step
    assert [c.name for c in sorted((tmp_path / "res" / "checkpoints").glob("step_*"))] == ["step_00000002.npz"]
    res0, res1 = (res for _, _, res in _results(tmp_path, "res_", _wait(
        _ranks(tmp_path, "res_", out=str(tmp_path / "res"), resume=True, **common))))
    assert res0["summary"]["resumed_at"] == 2 and res0["summary"]["steps"] == 4
    np.testing.assert_allclose(res0["losses"], res1["losses"], rtol=1e-5)
    np.testing.assert_allclose(res0["losses"], full0["losses"][2:], rtol=1e-5)
    with np.load(full0["summary"]["checkpoint"]) as a, np.load(res0["summary"]["checkpoint"]) as b:
        worst = max(float(np.max(np.abs(a[k] - b[k]))) for k in a.files)
    assert worst < 1e-6, f"two-rank resume diverged by {worst}"


def test_a_save_error_on_rank_0_stops_every_rank(data, tmp_path):
    done = _wait(_ranks(tmp_path, "fail", fail_save=True, out=str(tmp_path / "o"), save_every=1,
                        **data, **dict(FINETUNE, epochs=1)))
    (rc0, log0, r0), (rc1, log1, r1) = _results(tmp_path, "fail", done)
    assert rc0 != 0 and rc1 != 0
    assert r0["error"] == "RuntimeError" and "saving the step 2 checkpoint" in r0["message"]
    assert "OSError(28, 'No space left on device')" in r0["cause"], r0
    assert r1["error"] == "RuntimeError" and "rank 0 failed at saving the step 2 checkpoint" in r1["message"], r1
    assert not (tmp_path / "o" / "checkpoints").exists() or not list((tmp_path / "o" / "checkpoints").iterdir())


N_SLIDES = 6


def test_two_rank_cli_shares_one_output(data, tmp_path, monkeypatch):
    from atlaspatch_tpu_torch.utils.h5 import read_h5
    from torch_port_helpers import invoke_cli

    slides = tmp_path / "slides"
    slides.mkdir()
    rng = np.random.default_rng(7)
    for i in range(N_SLIDES):
        img = rng.uniform(150, 255, (384, 512, 3)).astype(np.uint8)
        img[64:320, 64:448] = (185, 130, 165)  # tissue blob
        Image.fromarray(img).save(slides / f"m{i}.png")
    csv = tmp_path / "mpp.csv"
    csv.write_text("wsi,mpp\n" + "".join(f"m{i}.png,0.5\n" for i in range(N_SLIDES)))

    def args(out):
        return ["segment-and-get-coords", str(slides), "-o", str(out), "--patch-size", "128", "--target-mag", "20",
                "--device", "cpu", "--mpp-csv", str(csv), "--sam2-checkpoint", data["checkpoint"], "--verbose"]

    port = _free_port()
    procs = _start(CLI_WORKER, args(tmp_path / "out"), [_env(r, port) for r in range(2)])
    monkeypatch.setattr(SAM2Config, "tiny", SAM2Config.test_tiny)
    one = invoke_cli("atlaspatch_tpu_torch", args(tmp_path / "one"))
    assert one.exit_code == 0 and f"Completed {N_SLIDES} slide(s), failures: 0" in one.output, one.output
    done = _wait(procs)
    for rc, log in done:
        assert rc == 0, log[-3000:]
        assert "torch.distributed initialized" in log and "backend gloo" in log
    logs = "\n".join(log for _, log in done)
    for i in range(N_SLIDES):
        a = read_h5(tmp_path / "one" / "patches" / f"m{i}.h5")
        b = read_h5(tmp_path / "out" / "patches" / f"m{i}.h5")
        assert int(b[1]["num_patches"]) > 0
        assert a[0]["coords"].tobytes() == b[0]["coords"].tobytes()
        assert sum(f"Processed m{i}.png" in log for _, log in done) == 1, logs[-3000:]
    assert all(f"Host {r}/2 takes 3 of {N_SLIDES} slides" in done[r][1] for r in range(2))
    assert list((tmp_path / "out" / "patches").glob("*.lock")) == []
