"""The port's serving micro-batcher (inklayer_tpu_torch.serve.batcher):
the cases of tests/test_batcher.py against its MicroBatcher, and its
BatchedSamEncoder on the TINY SAM of tests/test_sam.py against single
encodes and against the JAX package's BatchedSamEncoder.

Tolerances: batched against single encodes on the CPU in fp32, 1e-5
absolute (one model, a different batch size); against the JAX encoder, the
SAM parity tolerance atol = rtol = 1e-3 (tests/test_torch_sam.py).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu.serve.batcher import BatchedSamEncoder as JaxEncoder
from inklayer_tpu_torch.serve.batcher import BatchedSamEncoder, MicroBatcher
from tests.test_sam import TINY
from tests.test_torch_sam import sam_pair

MODEL = dict(atol=1e-3, rtol=1e-3)


def test_batcher_single():
    calls = []

    def fn(x):
        calls.append(x.shape[0])
        return x * 2

    b = MicroBatcher(fn, batch_buckets=(1, 2, 4), max_wait_ms=1.0)
    out = b(torch.ones(3))
    assert torch.equal(out, 2 * torch.ones(3))
    b.close()
    assert calls == [1]
    assert b.launches == {1: 1, 2: 0, 4: 0}


def test_batcher_coalesces_concurrent():
    seen = []

    def fn(x):
        seen.append(x.shape[0])
        return x + 1

    b = MicroBatcher(fn, batch_buckets=(1, 2, 4), max_wait_ms=50.0)
    futs = [b.submit(torch.full((2,), float(i))) for i in range(3)]
    results = [f.result(timeout=5) for f in futs]
    b.close()
    for i, r in enumerate(results):
        assert torch.equal(r, torch.full((2,), i + 1.0))
    # at least one call served several requests, padded to a bucket
    assert max(seen) >= 2 and all(s in (1, 2, 4) for s in seen)
    assert sum(b.launches.values()) == len(seen)
    assert sum(b * n for b, n in b.launches.items()) >= 3


def test_batcher_pads_by_repeating_the_last_input():
    seen = []
    b = MicroBatcher(lambda x: seen.append(x.clone()) or x, (1, 4), 50.0)
    futs = [b.submit(torch.full((2,), float(i))) for i in range(3)]
    for f in futs:
        f.result(timeout=5)
    b.close()
    assert len(seen) == 1 and seen[0][:, 0].tolist() == [0.0, 1.0, 2.0, 2.0]
    assert b.launches == {1: 0, 4: 1} and b.served == {1: 0, 4: 3}


def test_batcher_error_propagates():
    def fn(x):
        raise ValueError("boom")

    b = MicroBatcher(fn, batch_buckets=(1, 2, 4, 8), max_wait_ms=20.0)
    futs = [b.submit(torch.ones(1)) for _ in range(2)]
    for f in futs:  # every waiter of the batch
        with pytest.raises(ValueError):
            f.result(timeout=5)
    b.close()


def test_batcher_close_stops_the_worker():
    b = MicroBatcher(lambda x: x, batch_buckets=(1, 2, 4, 8),
                     max_wait_ms=1.0)
    b.close()
    assert not b._thread.is_alive()


@pytest.fixture(scope="module")
def pair():
    return sam_pair(std=0.5)


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((TINY.image_size, TINY.image_size, 3)
                                ).astype(np.float32) for _ in range(n)]


def test_batched_sam_encoder_matches_single_encodes(pair):
    """Three concurrent encodes (one launch of bucket 4) equal three single
    encodes."""
    _, _, tm = pair
    enc = BatchedSamEncoder(tm, batch_buckets=(1, 2, 4), max_wait_ms=500.0)
    images = [torch.from_numpy(x) for x in _images(3)]
    futs = [enc.batcher.submit(x) for x in images]
    got = [f.result(timeout=60) for f in futs]
    enc.close()
    assert enc.batcher.launches == {1: 0, 2: 0, 4: 1}
    for x, g in zip(images, got):
        assert g.shape == (4, 4, TINY.prompt_embed_dim)
        with torch.no_grad():
            want = tm.encode(x[None])[0]
        torch.testing.assert_close(g, want, atol=1e-5, rtol=0)


def test_batched_sam_encoder_matches_jax(pair):
    jm, params, tm = pair
    jax_enc = JaxEncoder(jm, params, batch_buckets=(1, 2), max_wait_ms=5.0)
    enc = BatchedSamEncoder(tm, batch_buckets=(1, 2), max_wait_ms=5.0)
    x = _images(1, seed=1)[0]
    want = np.asarray(jax_enc.encode(jnp.asarray(x)))
    got = enc.encode(torch.from_numpy(x))
    jax_enc.close()
    enc.close()
    np.testing.assert_allclose(got.numpy(), want, **MODEL)


def test_encoder_worker_runs_in_inference_mode(pair):
    """Inference mode is thread-local: the worker enters it itself."""
    _, _, tm = pair
    enc = BatchedSamEncoder(tm, batch_buckets=(1,), max_wait_ms=1.0)
    out = enc.encode(torch.from_numpy(_images(1)[0]))
    enc.close()
    assert out.is_inference() and not out.requires_grad


def test_predictor_routes_through_encode_fn(pair):
    from inklayer_tpu_torch.models.sam import SamPredictor

    _, _, tm = pair
    image = torch.from_numpy(
        (np.random.default_rng(2).random((50, 30, 3)) * 255).astype(np.uint8))
    direct = SamPredictor(tm, box_capacity=4).compute_image_state(image)
    enc = BatchedSamEncoder(tm, batch_buckets=(1, 2), max_wait_ms=1.0)
    routed = SamPredictor(tm, box_capacity=4, encode_fn=enc.encode)
    state = routed.compute_image_state(image)
    enc.close()
    assert enc.batcher.launches[1] == 1
    assert state["embedding"].shape == direct["embedding"].shape
    torch.testing.assert_close(state["embedding"], direct["embedding"],
                               atol=1e-5, rtol=0)


def test_launch_entries_and_counters_hold_under_threads():
    """Concurrent serving launches kernels from several threads: a launch
    entry point packs its argument struct and calls C as one step, and the
    launch counters lose no update (16 threads, a 1 us switch interval)."""
    import ctypes
    import struct
    import sys

    from inklayer_tpu_torch import _kernels

    class FakeFn:  # reads the struct back, as the C entry point does
        argtypes = restype = None

        def __call__(self, addr):
            return struct.unpack("@qq", ctypes.string_at(addr, 16))

    entry = _kernels._Entry(FakeFn(), "qq")
    saved = dict(_kernels.LAUNCHES)
    bad, n_threads, n_calls = [], 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _kernels.reset_launch_counts()

        def work(i):
            for j in range(n_calls):
                if entry(i, j) != (i, j):  # another thread's pack got in
                    bad.append(i)
                _kernels.count_launch("flash_attention", "d64")

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        counts = _kernels.launch_counts()
    finally:
        sys.setswitchinterval(interval)
        _kernels.LAUNCHES.clear()
        _kernels.LAUNCHES.update(saved)
    assert not bad
    assert counts["flash_attention"] == counts["flash_attention/d64"] == \
        n_threads * n_calls
