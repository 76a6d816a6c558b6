"""Port parity for the RPC transport (``pgl_tpu_torch.distributed.rpc``):
the reference's ``tests/test_rpc.py`` case by case on the port's server and
client, plus what the port adds — the framing is the reference's (the
same buffers under the same placeholders), the pickled skeleton names the
port and never ``pgl_tpu``, a torch tensor is refused on the wire, a call
keeps its own deadline, and a server process serves without importing
jax.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from pgl_tpu.distributed import rpc as jrpc
from pgl_tpu_torch.distributed.rpc import (RpcClient, RpcServer, _NpRef,
                                           _fill, _strip)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _EchoService:
    def echo(self, *args, **kwargs):
        return (args, kwargs)

    def boom(self):
        raise ValueError("intentional")

    def slow(self, seconds):
        time.sleep(seconds)
        return "done"

    def tensor(self):
        return torch.zeros(2)


@pytest.fixture(scope="module")
def server():
    srv = RpcServer(_EchoService()).start()
    yield srv
    srv.stop()


@pytest.fixture()
def client(server):
    c = RpcClient(f"{server.host}:{server.port}", timeout=10.0, retries=0)
    yield c
    c.close()


def test_scalar_and_string_round_trip(client):
    args, kwargs = client.call("echo", 1, "two", 3.5, key=[True, None])
    assert args == (1, "two", 3.5)
    assert kwargs == {"key": [True, None]}


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64, np.uint8, np.bool_])
def test_array_round_trip_dtypes(client, dtype):
    arr = np.arange(37).astype(dtype).reshape(1, 37)
    (out,), _ = client.call("echo", arr)
    assert out.dtype == arr.dtype and out.shape == arr.shape
    np.testing.assert_array_equal(out, arr)


def test_nested_structure_round_trip(client):
    payload = {
        "ids": np.arange(1000, dtype=np.int64),
        "feats": [np.random.default_rng(0).normal(size=(64, 16))
                  .astype(np.float32), "tag"],
        "empty": np.zeros((0, 3), np.float32),
        "scalar0d": np.array(2.5),
        "nested": (np.ones(4, np.uint8), {"deep": np.full((2, 2), 7)}),
    }
    (out,), _ = client.call("echo", payload)
    np.testing.assert_array_equal(out["ids"], payload["ids"])
    np.testing.assert_array_equal(out["feats"][0], payload["feats"][0])
    assert out["feats"][1] == "tag"
    assert out["empty"].shape == (0, 3)
    assert out["scalar0d"].shape == () and out["scalar0d"].item() == 2.5
    np.testing.assert_array_equal(out["nested"][0], payload["nested"][0])
    np.testing.assert_array_equal(out["nested"][1]["deep"],
                                  payload["nested"][1]["deep"])


def test_non_contiguous_array(client):
    arr = np.arange(100).reshape(10, 10)[::2, ::3]
    (out,), _ = client.call("echo", arr)
    np.testing.assert_array_equal(out, arr)


def test_large_array_round_trip(client):
    arr = np.random.default_rng(1).integers(0, 1 << 30, size=(1 << 20,)
                                            ).astype(np.int64)
    (out,), _ = client.call("echo", arr)
    np.testing.assert_array_equal(out, arr)


def test_arrays_bypass_pickle():
    """The pickled skeleton holds placeholders, not array bytes, and names
    the port's ``_NpRef``: unpickling it never imports ``pgl_tpu``."""
    bufs = []
    arr = np.arange(10000, dtype=np.float64)
    skeleton = _strip({"x": arr, "y": [arr, 1]}, bufs)
    assert len(bufs) == 2
    blob = pickle.dumps(skeleton)
    assert len(blob) < 500  # 160 kB of array data is NOT in the pickle
    assert b"pgl_tpu_torch.distributed.rpc" in blob
    assert b"pgl_tpu.distributed" not in blob
    assert isinstance(pickle.loads(blob)["x"], _NpRef)
    restored = _fill(pickle.loads(blob), bufs)
    np.testing.assert_array_equal(restored["x"], arr)
    np.testing.assert_array_equal(restored["y"][0], arr)
    assert restored["y"][1] == 1


def test_object_dtype_falls_back_to_pickle(client):
    arr = np.array(["a", None, 3], dtype=object)
    (out,), _ = client.call("echo", arr)
    assert list(out) == ["a", None, 3]


def test_remote_exception_propagates(client):
    with pytest.raises(RuntimeError, match="intentional"):
        client.call("boom")


def test_deadline_raises(server):
    c = RpcClient(f"{server.host}:{server.port}", timeout=0.3, retries=0,
                  retry_wait=0.0)
    try:
        with pytest.raises(TimeoutError):
            c.call("slow", 5.0)
    finally:
        c.close()


def test_per_call_deadline_overrides(client):
    """``call(..., timeout=)`` bounds one call below the client's own."""
    with pytest.raises(TimeoutError):
        client.call("slow", 5.0, timeout=0.3)


def test_tensor_refused_on_the_wire(client):
    """A torch tensor never crosses: the caller's raises before a byte is
    sent, and a server method returning one reports the refusal."""
    with pytest.raises(TypeError, match="numpy"):
        client.call("echo", torch.ones(3))
    with pytest.raises(RuntimeError, match="torch tensor"):
        client.call("tensor")
    (out,), _ = client.call("echo", torch.ones(3).numpy())
    np.testing.assert_array_equal(out, np.ones(3, np.float32))


def test_framing_is_the_references():
    """The same object tree frames into the same buffers, in the same
    order, under placeholders of the same index, dtype and shape as the
    reference's (only the placeholder's class differs: each package's
    own)."""
    payload = {"ids": np.arange(50, dtype=np.int64),
               "w": np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4)[
                   :, ::2],
               "tag": ("a", 2, [np.zeros((0, 3)), np.array(1.5)])}
    mine, theirs = [], []
    sk_mine = _strip(payload, mine)
    sk_theirs = jrpc._strip(payload, theirs)
    assert len(mine) == len(theirs) == 4
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    refs_mine, refs_theirs = [], []
    from pgl_tpu_torch.distributed.rpc import _collect_refs
    _collect_refs(sk_mine, refs_mine)
    jrpc._collect_refs(sk_theirs, refs_theirs)
    assert [(r.index, r.dtype, r.shape) for r in refs_mine] == \
        [(r.index, r.dtype, r.shape) for r in refs_theirs]
    assert sk_mine["tag"][:2] == sk_theirs["tag"][:2] == ("a", 2)


def test_server_process_imports_no_jax():
    """A port server and client in a process of their own, with the
    slice's modules imported: a round trip of arrays, and no jax, flax,
    optax or ``pgl_tpu`` module loaded."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import pgl_tpu_torch.apps.graph4rec
        import pgl_tpu_torch.distributed.launch
        import pgl_tpu_torch.distributed.ps
        import pgl_tpu_torch.models.kg
        import pgl_tpu_torch.utils.config
        from pgl_tpu_torch.distributed.rpc import RpcClient, RpcServer

        class Echo:
            def echo(self, x):
                return {"x": x, "n": len(x)}

        srv = RpcServer(Echo()).start()
        c = RpcClient(f"{srv.host}:{srv.port}", timeout=20.0)
        out = c.call("echo", np.arange(7))
        assert out["n"] == 7 and (out["x"] == np.arange(7)).all()
        c.close()
        srv.stop()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "flax", "optax", "pgl_tpu"))
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


def test_slice_modules_import_no_jax():
    """The slice's files import torch, numpy and the port only (an AST
    scan, as ``test_no_jax_in_parallel``)."""
    import ast
    import pathlib
    root = pathlib.Path(ROOT)
    files = sorted((root / "pgl_tpu_torch" / "distributed").glob("*.py"))
    files += [root / "pgl_tpu_torch" / p for p in (
        "apps/graph4rec.py", "models/kg.py", "utils/config.py")]
    files.append(root / "tests" / "torch_ps_procs.py")
    assert len(files) == 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "flax", "optax", "pgl_tpu"), \
                    f"{path.name} imports {name}"
