"""The port's HTTP front end (``serve.MultiServer``, ``_make_http_server``,
``main``) against the JAX package's, on the CPU.

One nano model (SWIN_DEPTHS (1,1,1,1), RESNET_STAGE_DEPTHS (1,1,1), f32,
224^2), its weights drawn with numpy on the JAX model's shape trace and
carried across by ``convert.load_jax_variables``, is served by both
packages' ``BatchingServer`` behind both packages' HTTP servers on free
ports of 127.0.0.1: the responses agree (atol 1e-5), ``/stats`` counts
alike, and every error answers the same status in both (404 for an
unknown model or route, 400 for a body that is no npy array, 503 for a
full queue, 504 for a request that waited past its timeout; the queue and
the timeout made deterministic by a predictor held at a gate).  The
port's ``MultiServer`` routes ``/predict`` and ``/predict/<model>`` to
two checkpoints' models, and ``main`` serves checkpoints written by the
port.  The JAX forward compiles at XLA optimization level 1.  Every
server is shut and every thread joined in ``finally``.
"""

import contextlib
import functools
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_common import COMPILE, random_variables

from swinvox_tpu_torch.convert import load_jax_variables

NANO = {"SWIN_DEPTHS": (1, 1, 1, 1), "RESNET_STAGE_DEPTHS": (1, 1, 1),
        "COMPUTE_DTYPE": "float32"}


def _nano(cfg):
    for k, v in NANO.items():
        setattr(cfg.NETWORK, k, v)
    return cfg


@pytest.fixture(scope="module")
def predictors():
    """(JAX Predictor, port Predictor, the variables) on one nano model."""
    from swinvox_tpu.config import default_config as jax_default
    from swinvox_tpu.infer import Predictor as JaxPredictor
    from swinvox_tpu.models.swinvox import SwinVoxModel as JaxModel

    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.infer import Predictor
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel

    jcfg = _nano(jax_default())
    jm = JaxModel.from_config(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 224, 224, 3)), train=False))
    variables = random_variables(shapes, seed=11)
    jp = JaxPredictor(jm, variables, jcfg)
    fn = jax.jit(lambda v, x: jax.nn.sigmoid(
        jm.apply(v, x, train=False)["refined_volumes"].astype(jnp.float32)))
    compiled = fn.lower(variables, jnp.zeros((2, 1, 224, 224, 3))).compile(
        compiler_options=COMPILE)
    jp._fn = compiled
    cfg = _nano(default_config())
    model = SwinVoxModel.from_config(cfg)
    load_jax_variables(model, variables)
    return jp, Predictor(model, "cpu", cfg), variables


@contextlib.contextmanager
def serving(make_http_server, server):
    """``server`` behind ``make_http_server`` on a free port, in a thread;
    yields the base URL; shuts, closes and joins everything after."""
    httpd = make_http_server(server, 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        server.close()
        assert not thread.is_alive()


def _npy(x) -> bytes:
    buf = io.BytesIO()
    np.save(buf, x)
    return buf.getvalue()


def post(url, body, timeout=120):
    """(status, body) of a POST."""
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None


def padded(predictor, x):
    """``predictor`` on ``x`` as a batch-2 server runs it: padded with a
    zero request."""
    batch = np.zeros((2, 1) + x.shape[1:], np.float32)
    batch[0] = x[:1]
    return predictor.predict(batch)[0]


def _requests():
    rng = np.random.default_rng(3)
    return [rng.standard_normal((n, 224, 224, 3)).astype(np.float32)
            for n in (1, 2)]  # a 2-view request is cut to the server's 1


def test_http_responses_match_the_jax_server(predictors):
    """The same requests, one at a time, through both HTTP servers: each
    response within atol 1e-5 of the JAX server's and equal to the port's
    Predictor on the request's first view; ``/stats`` counts alike; the
    error statuses of a single-model server alike."""
    from swinvox_tpu import serve as jax_serve

    from swinvox_tpu_torch import serve

    jp, pp, _ = predictors
    outs, stats = {}, {}
    for name, mod, pred in (("jax", jax_serve, jp), ("port", serve, pp)):
        server = mod.BatchingServer(pred, batch_size=2, n_views=1,
                                    max_wait_ms=1.0)
        with serving(mod._make_http_server, server) as url:
            got = []
            for x in _requests():
                status, body = post(f"{url}/predict", _npy(x))
                assert status == 200, (name, body)
                got.append(np.load(io.BytesIO(body)))
            small = _npy(np.zeros((1, 8, 8, 3), np.float32))
            errors = (post(f"{url}/predict/model", small)[0],
                      post(f"{url}/nope", small)[0],
                      post(f"{url}/predict", b"not an npy array")[0],
                      get(f"{url}/models")[0], get(f"{url}/nope")[0])
            status, stats[name] = get(f"{url}/stats")
            assert status == 200
        outs[name] = (got, errors)
    for a, b in zip(outs["port"][0], outs["jax"][0]):
        assert a.shape == b.shape == (32, 32, 32)
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert outs["port"][1] == outs["jax"][1] == (404, 404, 400, 404, 404)
    for name in ("jax", "port"):
        assert stats[name]["requests"] == stats[name]["batches"] == 2
    direct = pp.predict(np.stack([x[:1] for x in _requests()]))
    for a, b in zip(outs["port"][0], direct):
        np.testing.assert_array_equal(a, b)


class Gate:
    """A predictor whose ``predict`` waits at ``event`` (after telling
    ``entered``), then answers ones."""

    def __init__(self):
        self.entered, self.event = threading.Event(), threading.Event()

    def predict(self, batch):
        self.entered.set()
        assert self.event.wait(60)
        return np.ones((batch.shape[0], 4, 4, 4), np.float32)


def _held(url, gate, server):
    """Statuses of three requests to a gated server: the first held in
    ``predict``, the second queued behind it, then the third; 0.2 s later
    the gate opens."""
    x = np.zeros((1, 8, 8, 3), np.float32)
    res, threads = {}, []

    def start(i):
        def send():
            res[i] = post(f"{url}/predict", _npy(x))[0]
        threads.append(threading.Thread(target=send))
        threads[-1].start()

    try:
        start(0)
        assert gate.entered.wait(60)
        start(1)
        for _ in range(6000):  # until the second request is queued
            if server._queue.qsize() == 1:
                break
            time.sleep(0.01)
        start(2)
        time.sleep(0.2)
    finally:
        gate.event.set()
        for t in threads:
            t.join(timeout=60)
    return res[0], res[1], res[2]


@pytest.mark.parametrize("case", ["queue_full", "timeout"])
def test_overload_and_timeout_statuses_match_jax(case):
    """A full queue (max_queue 1) answers 503 and a request that waited
    past timeout_ms 504, in both packages; the held request succeeds."""
    from swinvox_tpu import serve as jax_serve

    from swinvox_tpu_torch import serve

    statuses = {}
    for name, mod in (("jax", jax_serve), ("port", serve)):
        gate = Gate()
        if case == "queue_full":
            server = mod.BatchingServer(gate, batch_size=1, n_views=1,
                                        max_wait_ms=0.0, max_queue=1)
        else:
            server = mod.BatchingServer(gate, batch_size=1, n_views=1,
                                        max_wait_ms=0.0, max_queue=4,
                                        timeout_ms=50.0)
        with serving(mod._make_http_server, server) as url:
            statuses[name] = _held(url, gate, server)
            stats = server.stats()
        want = (200, 200, 503) if case == "queue_full" else (200, 504, 504)
        assert statuses[name] == want, (name, statuses[name])
        key = "rejected_overload" if case == "queue_full" else "timed_out"
        assert stats[key] == (1 if case == "queue_full" else 2)
    assert statuses["port"] == statuses["jax"]


def test_multi_server_routes_to_each_model(predictors):
    """Two models behind one MultiServer: ``/models`` lists them,
    ``/predict`` goes to the default and ``/predict/<name>`` to the named
    one (each response equal to that model's Predictor), an unknown name
    answers 404, ``/stats`` is per model."""
    from swinvox_tpu_torch import serve
    from swinvox_tpu_torch.infer import Predictor
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel
    from swinvox_tpu_torch.serve import BatchingServer, MultiServer

    _, base, variables = predictors
    tuned_model = SwinVoxModel.from_config(base.cfg)
    load_jax_variables(tuned_model, variables)
    with torch.no_grad():
        tuned_model.refiner.fc2.bias.add_(0.5)
    tuned = Predictor(tuned_model, "cpu", base.cfg)
    ms = MultiServer({"base": BatchingServer(base, batch_size=2),
                      "tuned": BatchingServer(tuned, batch_size=2)},
                     default="base")
    x = _requests()[0]
    local = functools.partial(serve._make_http_server, host="127.0.0.1")
    with serving(local, ms) as url:
        assert get(f"{url}/models") == (200, {"models": ["base", "tuned"],
                                              "default": "base"})
        got = {}
        for path in ("/predict", "/predict/tuned", "/predict/base"):
            status, body = post(url + path, _npy(x))
            assert status == 200
            got[path] = np.load(io.BytesIO(body))
        assert post(f"{url}/predict/nope", _npy(x))[0] == 404
        status, stats = get(f"{url}/stats")
    assert status == 200
    assert stats["base"]["requests"] == 2 and stats["tuned"]["requests"] == 1
    want_base, want_tuned = padded(base, x), padded(tuned, x)
    np.testing.assert_array_equal(got["/predict"], want_base)
    np.testing.assert_array_equal(got["/predict/base"], want_base)
    np.testing.assert_array_equal(got["/predict/tuned"], want_tuned)
    assert np.abs(want_tuned - want_base).max() > 1e-3


def test_main_serves_port_checkpoints(predictors, tmp_path, monkeypatch):
    """``python -m swinvox_tpu_torch.serve --checkpoint a=A --checkpoint
    b=B --port 0 --platform cpu`` serves two checkpoints written by the
    port until its HTTP server is shut down, then closes its models."""
    from swinvox_tpu_torch import serve
    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.infer import Predictor
    from swinvox_tpu_torch.train.checkpoint import save_params_only

    _, base, _ = predictors
    paths = {}
    for name, shift in (("a", 0.0), ("b", 0.25)):
        with torch.no_grad():
            base.model.refiner.fc2.bias.add_(shift)
            paths[name] = str(tmp_path / f"{name}.ckpt")
            save_params_only(paths[name], base.model)
            base.model.refiner.fc2.bias.sub_(shift)
    real = Predictor.from_checkpoint
    monkeypatch.setattr(Predictor, "from_checkpoint", classmethod(
        lambda cls, path, cfg=None, device="cuda": real.__func__(
            cls, path, _nano(default_config()), device)))
    ready = []
    done = threading.Event()
    argv = ["--checkpoint", f"a={paths['a']}", "--checkpoint",
            f"b={paths['b']}", "--port", "0", "--host", "127.0.0.1",
            "--batch-size", "2", "--platform", "cpu"]
    thread = threading.Thread(target=lambda: (
        serve.main(argv, on_ready=ready.append), done.set()), daemon=True)
    thread.start()
    try:
        for _ in range(3000):
            if ready:
                break
            time.sleep(0.01)
        url = f"http://127.0.0.1:{ready[0].server_address[1]}"
        x = _requests()[0]
        got = {p: np.load(io.BytesIO(post(url + p, _npy(x))[1]))
               for p in ("/predict", "/predict/b")}
        assert get(f"{url}/models")[1] == {"models": ["a", "b"],
                                          "default": "a"}
    finally:
        if ready:
            ready[0].shutdown()
        thread.join(timeout=60)
    assert done.is_set() and not thread.is_alive()
    for path, name in (("/predict", "a"), ("/predict/b", "b")):
        want = padded(Predictor.from_checkpoint(paths[name], device="cpu"), x)
        np.testing.assert_array_equal(got[path], want)
    assert np.abs(got["/predict/b"] - got["/predict"]).max() > 1e-3


def test_cudnn_flags_hold_while_any_thread_predicts():
    """Two servers' dispatchers predict at once: the process-wide cuDNN
    flags stay deterministic while either is inside ``cudnn_deterministic``
    and come back as they were only when both have left (a save and
    restore per thread let the first to leave clear them under the other,
    so its convs ran cuDNN's nondeterministic algorithms)."""
    from swinvox_tpu_torch.utils.cudnn import cudnn_deterministic

    cudnn = torch.backends.cudnn
    before = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = False, True
    a_in, a_out, b_in, b_checked = (threading.Event() for _ in range(4))
    seen = {}

    def first():
        with cudnn_deterministic():
            a_in.set()
            assert b_in.wait(30)
        a_out.set()

    def second():
        assert a_in.wait(30)
        with cudnn_deterministic():
            b_in.set()
            assert a_out.wait(30)
            seen["inside"] = (cudnn.deterministic, cudnn.benchmark)
        b_checked.set()

    threads = [threading.Thread(target=f) for f in (first, second)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert b_checked.is_set()
        assert seen["inside"] == (True, False)
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    finally:
        cudnn.deterministic, cudnn.benchmark = before
