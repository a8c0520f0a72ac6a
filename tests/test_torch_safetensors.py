# The port's safetensors reader and writer against the safetensors package
# (which the port does not use): every dtype the repository writes, a
# scalar, an empty tensor, __metadata__, and an offset that is not a
# multiple of the item size, bit for bit in both directions.
import json
import struct
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load
from safetensors.numpy import save_file as st_save

from copilot_for_consensus_tpu_torch.checkpoint import safetensors as port

_RNG = np.random.default_rng(0)

ARRAYS = {
    "F32": _RNG.standard_normal((3, 5)).astype(np.float32),
    "F16": _RNG.standard_normal((4, 2)).astype(np.float16),
    "BF16": _RNG.standard_normal((7, 3)).astype(ml_dtypes.bfloat16),
    "I8": _RNG.integers(-128, 128, (9, 4)).astype(np.int8),
    "U8": _RNG.integers(0, 256, (6,)).astype(np.uint8),
    "I32": _RNG.integers(-2**31, 2**31, (2, 3, 2)).astype(np.int32),
    "I64": _RNG.integers(-2**62, 2**62, (5,)).astype(np.int64),
    "scalar": np.array(3.25, dtype=np.float32),
    "empty": np.zeros((0, 4), dtype=np.int8),
}


def _bits(x) -> tuple:
    """(shape, raw bytes) of a numpy array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    elif x.dtype == ml_dtypes.bfloat16:
        x = x.view(np.int16)
    return tuple(x.shape), np.ascontiguousarray(x).tobytes()


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_reads_the_packages_files_bit_equal(name, tmp_path):
    path = tmp_path / "x.safetensors"
    st_save({"t": ARRAYS[name], "pad": ARRAYS["U8"]}, str(path))
    got = port.load_file(path)
    assert _bits(got["t"]) == _bits(ARRAYS[name])
    assert _bits(got["pad"]) == _bits(ARRAYS["U8"])


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_package_reads_the_ports_files_bit_equal(name, tmp_path):
    path = tmp_path / "x.safetensors"
    port.save_file({"t": _torch(ARRAYS[name]), "pad": _torch(ARRAYS["U8"])},
                   path)
    got = st_load(str(path))
    assert _bits(got["t"]) == _bits(ARRAYS[name])
    assert _bits(got["pad"]) == _bits(ARRAYS["U8"])


def test_whole_files_round_trip_with_metadata(tmp_path):
    a, b = tmp_path / "a.safetensors", tmp_path / "b.safetensors"
    st_save(ARRAYS, str(a), metadata={"format": "pt", "k": "v"})
    f = port.SafetensorsFile(a)
    assert f.metadata == {"format": "pt", "k": "v"}
    assert sorted(f.keys()) == sorted(ARRAYS)
    n = port.save_file(port.load_file(a), b, metadata=f.metadata)
    assert n == b.stat().st_size
    back = st_load(str(b))
    for k, v in ARRAYS.items():
        assert _bits(back[k]) == _bits(v), k
    from safetensors import safe_open

    with safe_open(str(b), framework="np") as g:
        assert g.metadata() == {"format": "pt", "k": "v"}


def test_every_offset_of_a_written_file_is_aligned(tmp_path):
    path = tmp_path / "x.safetensors"
    port.save_file({k: _torch(v) for k, v in ARRAYS.items()}, path)
    raw = path.read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    assert (8 + n) % 8 == 0
    header = json.loads(raw[8:8 + n])
    sizes = {"F32": 4, "F16": 2, "BF16": 2, "I8": 1, "U8": 1, "I32": 4,
             "I64": 8}
    for e in header.values():
        assert e["data_offsets"][0] % sizes[e["dtype"]] == 0


def _handmade(path, entries, data: bytes):
    # the data starts 8-aligned, so offsets within it keep their alignment
    raw = json.dumps(entries).encode()
    raw += b" " * (-len(raw) % 8)
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + data)


@pytest.mark.parametrize("dtype,np_dtype", [("F32", np.float32),
                                            ("I64", np.int64),
                                            ("BF16", ml_dtypes.bfloat16)])
def test_offset_not_aligned_is_copied_bit_equal(dtype, np_dtype, tmp_path):
    # one byte ahead of the tensor: its offset is not a multiple of its
    # item size, so the reader copies instead of viewing
    want = _RNG.standard_normal((3, 3)).astype(np_dtype)
    if np_dtype is np.int64:
        want = _RNG.integers(-2**40, 2**40, (3, 3)).astype(np.int64)
    body = want.tobytes()
    path = tmp_path / "x.safetensors"
    _handmade(path, {"b": {"dtype": "U8", "shape": [1],
                           "data_offsets": [0, 1]},
                     "t": {"dtype": dtype, "shape": [3, 3],
                           "data_offsets": [1, 1 + len(body)]}},
              b"\x07" + body)
    got = port.load_file(path)
    assert got["b"].tolist() == [7]
    assert _bits(got["t"]) == _bits(want)


def test_mapped_tensors_do_not_warn_nor_write_the_file(tmp_path):
    path = tmp_path / "x.safetensors"
    st_save({"w": ARRAYS["F32"]}, str(path))
    before = path.read_bytes()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = port.load_file(path)["w"]
    t.add_(1.0)                      # copy-on-write: the file keeps its bytes
    assert path.read_bytes() == before
    assert _bits(port.load_file(path)["w"]) == _bits(ARRAYS["F32"])


def test_device_and_strided_tensors_are_written_contiguous(tmp_path):
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4).T
    path = tmp_path / "x.safetensors"
    port.save_file({"w": w}, path)
    assert st_load(str(path))["w"].tolist() == w.tolist()


@pytest.mark.parametrize("case", ["dtype", "offsets", "length", "header"])
def test_malformed_files_are_refused(case, tmp_path):
    path = tmp_path / "x.safetensors"
    if case == "dtype":
        _handmade(path, {"t": {"dtype": "F8_E4M3", "shape": [1],
                               "data_offsets": [0, 1]}}, b"\0")
    elif case == "offsets":
        _handmade(path, {"t": {"dtype": "F32", "shape": [2],
                               "data_offsets": [0, 4]}}, b"\0" * 8)
    elif case == "length":
        _handmade(path, {"t": {"dtype": "F32", "shape": [4],
                               "data_offsets": [0, 16]}}, b"\0" * 8)
    else:
        path.write_bytes(struct.pack("<Q", 1 << 40) + b"{}")
    with pytest.raises(port.SafetensorsError):
        port.load_file(path)


def test_unsupported_dtypes_are_refused_on_write(tmp_path):
    with pytest.raises(port.SafetensorsError):
        port.save_file({"t": torch.zeros(2, dtype=torch.complex64)},
                       tmp_path / "x.safetensors")
    with pytest.raises(port.SafetensorsError):
        port.save_file({"t": torch.zeros(2, dtype=torch.float64)},
                       tmp_path / "x.safetensors")


def test_rewriting_a_mapped_file_keeps_its_readers(tmp_path):
    # the writer renames a new file over the old one: a tensor mapped from
    # the old file keeps its bytes (truncating in place would fault it)
    path = tmp_path / "x.safetensors"
    st_save({"w": ARRAYS["F32"]}, str(path))
    old = port.load_file(path)["w"]
    port.save_file({"w": torch.zeros(100, 100)}, path)
    assert _bits(old) == _bits(ARRAYS["F32"])
    assert port.load_file(path)["w"].shape == (100, 100)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["x.safetensors"]
