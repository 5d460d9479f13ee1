"""The port's bounded-memory readers (io/chunked.py) and WebHDFS
transport (io/webhdfs.py) against the JAX package's, on the CPU.

The same seeded libsvm text goes through both packages' readers:
``scan_libsvm_dims``, ``iter_libsvm_batches`` (dense and sparse),
``grid_spans`` and ``iter_hdf5_batches`` give the same values, bit for
bit; ``prefetch_batches`` keeps order and values and re-raises a
producer's error in place; ``read_libsvm_sharded`` over 1-D, ragged and
2-D gloo meshes gives every rank the whole of ``read_libsvm``'s arrays
and each rank torch's split of the rows. WebHDFS runs against a REST stub
on the loopback address (the namenode's 307 redirect to a data URL,
then the bytes), with a dropped connection that resumes at its byte
offset.
"""

import http.server
import threading
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from libskylark_tpu import io as rio
from libskylark_tpu.io import chunked as rchunked
from libskylark_tpu_torch import io as pio
from libskylark_tpu_torch.base import errors
from libskylark_tpu_torch.io import chunked
from libskylark_tpu_torch.resilience import faults
from libskylark_tpu_torch.resilience.policy import RetryPolicy


def _write(tmp_path, **kw):
    p = tmp_path / "data.libsvm"
    p.write_text("".join(W.io_libsvm_lines(**kw)))
    return str(p)


def test_scan_dims_matches_the_reference(tmp_path):
    p = _write(tmp_path, n=40, d=11, targets=2)
    assert pio.scan_libsvm_dims(p) == rio.scan_libsvm_dims(p)
    assert pio.scan_libsvm_dims(p, max_n=7) == rio.scan_libsvm_dims(p, 7)


@pytest.mark.parametrize("batch_rows", [1, 7, 64])
def test_dense_batches_match_the_reference(tmp_path, batch_rows):
    p = _write(tmp_path, n=40, d=11)
    got = list(pio.iter_libsvm_batches(p, batch_rows, max_n=33))
    want = list(rio.iter_libsvm_batches(p, batch_rows, max_n=33))
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_sparse_batches_match_the_reference(tmp_path):
    p = _write(tmp_path, n=30, d=13, targets=2)
    got = list(pio.iter_libsvm_batches(p, 8, sparse=True))
    want = list(rio.iter_libsvm_batches(p, 8, sparse=True))
    for (gx, gy), (wx, wy) in zip(got, want, strict=True):
        np.testing.assert_array_equal(gx.to_scipy().toarray(),
                                      np.asarray(wx.todense()))
        np.testing.assert_array_equal(gy, wy)


def test_one_shot_stream_needs_d_and_refuses_wide_rows(tmp_path):
    lines = W.io_libsvm_lines(n=10, d=9)
    with pytest.raises(errors.InvalidParametersError):
        next(pio.iter_libsvm_batches(iter(lines), 4))
    with pytest.raises(errors.IOError_):
        list(pio.iter_libsvm_batches(iter(lines), 4, d=2))
    xs = [x for x, _ in pio.iter_libsvm_batches(iter(lines), 4, d=9)]
    np.testing.assert_array_equal(
        np.concatenate(xs), rio.read_libsvm(_write(tmp_path, n=10, d=9),
                                            min_d=9)[0])


def test_array_batches_and_grid_spans():
    X = np.arange(30.0).reshape(10, 3)
    Y = np.arange(10.0)
    got = list(pio.chunked.iter_array_batches(X, 4, Y))
    assert [len(x) for x, _ in got] == [4, 4, 2]
    np.testing.assert_array_equal(np.concatenate([y for _, y in got]), Y)
    with pytest.raises(errors.InvalidParametersError):
        list(pio.chunked.iter_array_batches(X, 4, Y[:3]))
    for lo, hi, b in ((0, 10, 4), (5, 23, 4), (3, 3, 2), (2, 9, 0)):
        assert (list(chunked.grid_spans(lo, hi, b))
                == list(rchunked.grid_spans(lo, hi, b)))


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_keeps_order_and_values(depth):
    batches = [(np.full((3, 2), i, np.float32), i) for i in range(7)]
    got = list(pio.prefetch_batches(iter(batches), depth=depth,
                                    device="cpu"))
    assert [i for _, i in got] == list(range(7))
    for (x, i), (w, _) in zip(got, batches):
        assert isinstance(x, torch.Tensor)
        np.testing.assert_array_equal(x.numpy(), w)
    raw = list(pio.prefetch_batches(iter(batches), depth=depth,
                                    to_device=False))
    assert all(isinstance(x, np.ndarray) for x, _ in raw)


def test_prefetch_reraises_after_the_batches_before():
    def gen():
        yield (np.zeros(2), 0)
        yield (np.ones(2), 1)
        raise errors.IOError_("parser died")

    seen = []
    with pytest.raises(errors.IOError_, match="parser died"):
        for _, i in pio.prefetch_batches(gen(), depth=2, to_device=False):
            seen.append(i)
    assert seen == [0, 1]


def test_hdf5_batches_match_and_retry(tmp_path):
    pytest.importorskip("h5py")
    rng = np.random.default_rng(3)
    X = rng.standard_normal((37, 5))
    Y = rng.standard_normal(37)
    p = str(tmp_path / "d.h5")
    rio.write_hdf5(p, X, Y)
    got = list(pio.iter_hdf5_batches(p, 8, start_row=5, stop_row=30))
    want = list(rio.iter_hdf5_batches(p, 8, start_row=5, stop_row=30))
    for (gx, gy), (wx, wy) in zip(got, want, strict=True):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    plan = {"faults": [{"site": "io.chunked.read", "error": "IOError_",
                        "on_hit": 2}]}
    fast = RetryPolicy(max_attempts=3, base_delay=0.0, max_delay=0.0,
                       sleep=lambda s: None)
    with faults.fault_plan(plan):
        again = list(pio.iter_hdf5_batches(p, 8, start_row=5, stop_row=30,
                                           retry=fast))
    for (gx, _), (ax, _) in zip(got, again, strict=True):
        np.testing.assert_array_equal(gx, ax)


def test_read_libsvm_sharded_over_gloo_meshes():
    """Every rank of each mesh holds the whole of ``read_libsvm``'s (X, Y)
    (gathered), and its own block is torch's split of the rows along the
    axis."""
    ranks = W.run_group("io_sharded", world=4)
    for name, (mname, axis, lkw, rkw, src) in W.IO_CASES.items():
        lines = W.io_libsvm_lines(**lkw)
        n_max = rkw.get("max_n", -1)
        X, Y = rio.read_libsvm(iter_text(lines), max_n=n_max)
        n = X.shape[0]
        shape, k = W.MESHES[mname]
        p = shape[0 if axis == "rows" else 1]
        chunk = -(-n // p)
        for r in range(k):
            got = ranks[r][f"x/{name}"]
            # a stream cut at max_n keeps the scan's d; the columns past
            # the reference's are empty
            np.testing.assert_array_equal(got[:, :X.shape[1]], X,
                                          err_msg=name)
            assert not got[:, X.shape[1]:].any()
            np.testing.assert_array_equal(ranks[r][f"y/{name}"], Y,
                                          err_msg=name)
            coord = r // shape[1] if (len(shape) > 1 and axis == "rows") \
                else (r % shape[1] if len(shape) > 1 else r)
            want_rows = max(0, min(chunk, n - coord * chunk))
            assert int(ranks[r][f"rows/{name}"]) == want_rows, (name, r)


def iter_text(lines):
    import io

    return io.StringIO("".join(lines))


def test_read_libsvm_sharded_needs_dims_for_a_stream():
    with pytest.raises(errors.InvalidParametersError, match="dims"):
        pio.read_libsvm_sharded(iter(W.io_libsvm_lines()), object())


class _WebHDFSStub:
    """A WebHDFS REST endpoint on 127.0.0.1: the namenode answers OPEN
    with a 307 to /data on the same server, which serves the file's bytes
    from the ``offset`` asked for (each OPEN's offset kept in
    ``opens``)."""

    def __init__(self, files: dict):
        stub = self
        self.files, self.opens = files, []

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                if u.path.startswith("/webhdfs/v1"):
                    assert q.get("op") == ["OPEN"], q
                    off = int(q.get("offset", ["0"])[0])
                    stub.opens.append(off)
                    self.send_response(307)
                    self.send_header(
                        "Location", f"http://127.0.0.1:{stub.port}/data"
                        f"{u.path[len('/webhdfs/v1'):]}?offset={off}")
                    self.end_headers()
                    return
                body = stub.files.get(u.path[len("/data"):])
                if body is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                body = body[int(q.get("offset", ["0"])[0]):]
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_webhdfs_lines_and_reader_seam():
    content = "".join(f"line {i} αβ\n" for i in range(300)) + "tail"
    lines = W.io_libsvm_lines(n=25, d=9)
    stub = _WebHDFSStub({"/u/x.txt": content.encode(),
                         "/u/d.libsvm": "".join(lines).encode()})
    try:
        got = list(pio.webhdfs_lines(stub.url, "/u/x.txt",
                                     buffer_bytes=256))
        n, d, _ = pio.scan_libsvm_dims(pio.webhdfs_lines(stub.url,
                                                         "/u/d.libsvm"))
        xs = [x for x, _ in pio.iter_libsvm_batches(
            pio.webhdfs_lines(stub.url, "/u/d.libsvm"), 10, d=d)]
    finally:
        stub.close()
    assert got == content.splitlines(keepends=True)
    X, _ = rio.read_libsvm(iter_text(lines))
    np.testing.assert_array_equal(np.concatenate(xs), X)


def test_webhdfs_reconnects_at_the_consumed_offset():
    """A read that fails mid-stream (the ``io.webhdfs.read`` fault site)
    reopens at the bytes consumed so far; the lines are those of an
    uninterrupted read."""
    from libskylark_tpu_torch.io import webhdfs

    content = "".join(f"row {i}\n" for i in range(400)).encode()
    stub = _WebHDFSStub({"/u/r.txt": content})
    retry = webhdfs.default_retry()
    retry.sleep = lambda s: None
    plan = {"faults": [{"site": "io.webhdfs.read", "error": "IOError_",
                        "on_hit": 4}]}
    try:
        with faults.fault_plan(plan):
            got = "".join(webhdfs.webhdfs_lines(
                stub.url, "/u/r.txt", buffer_bytes=128, retry=retry))
    finally:
        stub.close()
    assert got.encode() == content
    assert stub.opens == [0, 3 * 128]


def test_webhdfs_refuses_a_missing_file_without_retry():
    from libskylark_tpu_torch.io import webhdfs

    stub = _WebHDFSStub({})
    try:
        with pytest.raises(errors.IOError_, match="404") as e:
            list(webhdfs.webhdfs_lines(stub.url, "/nope"))
    finally:
        stub.close()
    assert any(t.startswith("attempts=1/") for t in e.value.trace)
    assert stub.opens == [0]
