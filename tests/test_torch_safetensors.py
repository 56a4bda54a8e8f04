"""The port's own ``.safetensors`` reader (atlaspatch_tpu_torch/utils/safetensors.py)
against the ``safetensors`` module and the JAX zoo's loader.

Files written by ``safetensors`` itself are read by the port tensor for
tensor equal (and of the same dtype) to ``safetensors.numpy`` on every dtype
numpy holds, and to ``safetensors.torch`` on BF16, which numpy holds only
through ml_dtypes (without it the JAX zoo's ``safe_open(framework="np")``
raises on BF16); a 2-shard F32
checkpoint merges in ``zoo._load_state_dict`` as in the JAX zoo. Truncated
files, overlapping offsets, offsets that disagree with the shape and
unknown dtypes are refused with a message naming the tensor; the reader
works with the module's import blocked; the tensors are copy-on-write views
of the file.
"""

import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as save_numpy
from safetensors.torch import load_file as torch_load_file
from safetensors.torch import save_file as save_torch

from atlaspatch_tpu.models.encoders import zoo as jax_zoo
from atlaspatch_tpu_torch.models.encoders import zoo
from atlaspatch_tpu_torch.utils import safetensors as st

NUMPY_DTYPES = [np.float64, np.float32, np.float16, np.int64, np.int32, np.int16, np.int8,
                np.uint8, np.bool_]


def _arrays(dtype, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 5), "b.weight": (7,), "c": (2, 3, 4), "scalar": (), "empty": (0, 4)}
    out = {}
    for name, shape in shapes.items():
        v = rng.normal(0.0, 10.0, shape)
        out[name] = np.asarray(v > 0) if dtype is np.bool_ else np.asarray(v).astype(dtype)
    return out


@pytest.mark.parametrize("dtype", NUMPY_DTYPES, ids=lambda d: np.dtype(d).name)
def test_reads_what_safetensors_numpy_reads(tmp_path, dtype):
    from safetensors.numpy import load_file

    path = tmp_path / "w.safetensors"
    save_numpy(_arrays(dtype), str(path), metadata={"format": "np"})
    want, got = load_file(str(path)), st.load_file(path)
    assert list(got) == list(st.read_header(path)[0]) and sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].numpy().dtype == arr.dtype and got[key].shape == arr.shape, key
        assert np.array_equal(got[key].numpy(), arr), key
    assert st.read_header(path)[1] == {"format": "np"}


def test_reads_bf16_as_safetensors_torch_does(tmp_path):
    path = tmp_path / "w.safetensors"
    rng = np.random.default_rng(1)
    tensors = {f"t{i}": torch.from_numpy(rng.normal(0, 3, (4, i + 1)).astype(np.float32)).bfloat16()
               for i in range(5)}
    tensors["mixed_f32"] = torch.arange(6, dtype=torch.float32)
    save_torch(tensors, str(path))
    want, got = torch_load_file(str(path)), st.load_file(path)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


def test_the_jax_reader_refuses_bf16(tmp_path):
    """The fault the port does not copy: the JAX zoo reads with
    safe_open(framework="np"), which raises on BF16 in a process where
    ml_dtypes has not registered numpy's bfloat16 (where JAX is loaded it
    has, and the JAX zoo gets ml_dtypes bfloat16 arrays, which its ``_np``
    does not upcast). The port reads torch.bfloat16 in either process."""
    path = tmp_path / "w.safetensors"
    save_torch({"w": torch.full((3,), 1.5, dtype=torch.bfloat16)}, str(path))
    script = f"""
from safetensors import safe_open
try:
    with safe_open({str(path)!r}, framework="np") as f:
        f.get_tensor("w")
except TypeError as e:
    print("TypeError", e)
"""
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120)
    assert proc.stdout.startswith("TypeError") and "bfloat16" in proc.stdout, proc.stdout + proc.stderr
    assert jax_zoo._load_state_dict(path)["w"].dtype.name == "bfloat16"  # ml_dtypes, JAX loaded
    got = zoo._load_state_dict(path)["w"]
    assert got.dtype == torch.bfloat16 and torch.equal(got.float(), torch.full((3,), 1.5))


def test_two_shards_merge_as_in_the_jax_zoo(tmp_path):
    rng = np.random.default_rng(2)
    shards = [{f"blocks.{i}.w": rng.normal(0, 1, (8, 4)).astype(np.float32) for i in range(s, s + 3)}
              for s in (0, 3)]
    for i, part in enumerate(shards, 1):
        save_numpy(part, str(tmp_path / f"model-0000{i}-of-00002.safetensors"))
    first = tmp_path / "model-00001-of-00002.safetensors"
    want, got = jax_zoo._load_state_dict(first), zoo._load_state_dict(first)
    assert sorted(got) == sorted(want) and len(got) == 6
    for key in want:
        assert np.array_equal(got[key].numpy(), want[key]), key


def _raw(header: dict, data: bytes, *, length: int | None = None) -> bytes:
    blob = json.dumps(header).encode()
    return struct.pack("<Q", len(blob) if length is None else length) + blob + data


REFUSED = {
    "empty file": (b"", "truncated"),
    "header past the end": (_raw({}, b"", length=4096), "truncated"),
    "tensor past the end": (_raw({"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}, b"\0" * 8),
                            "truncated"),
    "overlap": (_raw({"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
                      "b": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}}, b"\0" * 12), "overlap"),
    "unknown dtype": (_raw({"a": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}}, b"\0" * 2),
                      "unknown dtype"),
    "offsets disagree with shape": (_raw({"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}},
                                         b"\0" * 12), "needs 12"),
    "not JSON": (struct.pack("<Q", 4) + b"{{{{", "not JSON"),
    "malformed entry": (_raw({"a": {"dtype": "F32"}}, b""), "malformed"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_name_the_fault(tmp_path, case):
    blob, message = REFUSED[case]
    path = tmp_path / "bad.safetensors"
    path.write_bytes(blob)
    with pytest.raises(st.SafetensorsError, match=message) as info:
        st.load_file(path)
    assert "bad.safetensors" in str(info.value)


def test_truncated_real_file_is_refused(tmp_path):
    path = tmp_path / "w.safetensors"
    save_numpy(_arrays(np.float32), str(path))
    path.write_bytes(path.read_bytes()[:-3])
    with pytest.raises(st.SafetensorsError, match="truncated"):
        st.load_file(path)


def test_views_are_copy_on_write(tmp_path):
    path = tmp_path / "w.safetensors"
    save_numpy({"a": np.arange(8, dtype=np.float32)}, str(path))
    before = path.read_bytes()
    t = st.load_file(path)["a"]
    t += 1  # writable views (torch.frombuffer needs one); the file stays as it was
    assert path.read_bytes() == before and torch.equal(t, torch.arange(1, 9, dtype=torch.float32))


def test_reads_with_the_module_blocked(tmp_path):
    path = tmp_path / "w.safetensors"
    save_torch({"bf": torch.full((2, 3), 1.5, dtype=torch.bfloat16), "f": torch.ones(4)}, str(path))
    script = f"""
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "safetensors":
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Refuse())
for name in [m for m in sys.modules if m.split(".")[0] == "safetensors"]:
    del sys.modules[name]
from atlaspatch_tpu_torch.models.encoders import zoo
sd = zoo._load_state_dict(__import__("pathlib").Path({str(path)!r}))
assert not any(m.split(".")[0] == "safetensors" for m in sys.modules)
print(sorted(sd), sd["bf"].dtype, float(sd["bf"].float().sum()), float(sd["f"].sum()))
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["['bf',", "'f']", "torch.bfloat16", "9.0", "4.0"]
