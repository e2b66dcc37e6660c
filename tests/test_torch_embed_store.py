"""The port's two-tier embedding store (``fm_spark_tpu_torch.embed``)
against its contract and against the JAX package's store.

The cases of ``tests/test_embed_store.py`` one for one, on the CPU
(``device="cpu"``: the hot planes are CPU tensors, installs and flushes
plain copies); then the port's :class:`TieredStore` and the reference's
driven by one seeded id sequence with the same write-through between
batches: the same local ids, residency, versions, ``stats()`` and merged
planes, bit for bit; and the lazy cold stores' buckets.
"""

import numpy as np
import pytest
import torch

from fm_spark_tpu_torch.embed import BucketPrefetcher, ColdStore, TieredStore

R = 4          # bucket_rows
N_ROWS = 32    # 8 buckets
HOT = 2        # hot-tier capacity in buckets


def make_dense(n_rows=N_ROWS, bucket_rows=R):
    """One rank-2 plane ('v') + one rank-1 plane ('w') with
    row-identifying values, so any aliasing or misplaced install is
    visible in the bytes."""
    v = (np.arange(n_rows, dtype=np.float32)[:, None]
         + np.array([0.0, 0.25], np.float32)[None, :])
    w = np.arange(n_rows, dtype=np.float32) * 10.0
    return ColdStore.dense({"v": v.copy(), "w": w.copy()}, bucket_rows)


def store_of(cold, hot_buckets=HOT):
    return TieredStore(cold, hot_buckets, device="cpu")


def gather_hot(hot, local_ids):
    return hot["v"].numpy()[np.asarray(local_ids).ravel()]


# --------------------------------------------------------------- ColdStore


def test_cold_dense_bucket_roundtrip_and_copy_semantics():
    cold = make_dense()
    blk = cold.read_bucket("v", 2)
    assert blk.shape == (R, 2)
    assert np.array_equal(blk[:, 0], np.arange(8, 12, dtype=np.float32))
    blk[...] = -1.0
    assert cold.read_bucket("v", 2)[0, 0] == 8.0
    cold.write_bucket("v", 2, blk)
    assert np.all(cold.read_bucket("v", 2) == -1.0)
    assert cold.read_bucket("v", 3)[0, 0] == 12.0


def test_cold_dense_rejects_ragged_axis():
    with pytest.raises(ValueError, match="must divide"):
        ColdStore.dense({"v": np.zeros((30, 2), np.float32)}, R)
    with pytest.raises(ValueError, match="rows"):
        ColdStore({"v": np.zeros((32, 2), np.float32),
                   "w": np.zeros((28,), np.float32)}, R, 32)


def test_cold_lazy_materializes_on_touch_deterministically():
    calls = []

    def init(plane, bucket, shape, dtype):
        calls.append((plane, bucket))
        return np.full(shape, float(bucket), dtype)

    cold = ColdStore.lazy({"v": ((2,), np.dtype(np.float32))}, R, N_ROWS,
                          init)
    assert cold.is_lazy
    assert cold.host_bytes() == 0 and cold.touched_buckets() == 0
    a = cold.read_bucket("v", 3)
    b = cold.read_bucket("v", 3)
    assert np.array_equal(a, b) and np.all(a == 3.0)
    assert calls == [("v", 3)]
    assert cold.touched_buckets() == 1
    assert cold.host_bytes() == R * 2 * 4
    with pytest.raises(ValueError, match="lazy"):
        cold.dense_plane("v")


def test_cold_lazy_write_back_overrides_init():
    cold = ColdStore.lazy({"v": ((2,), np.dtype(np.float32))}, R, N_ROWS,
                          lambda p, b, s, d: np.zeros(s, d))
    cold.write_bucket("v", 5, np.full((R, 2), 7.0, np.float32))
    assert np.all(cold.read_bucket("v", 5) == 7.0)


@pytest.mark.parametrize("lazy", [False, True], ids=["dense", "lazy"])
def test_cold_write_back_read_back_round_trips(tmp_path, lazy):
    if lazy:
        init = (lambda p, b, s, d: np.full(s, float(b), d))
        cold = ColdStore.lazy({"v": ((2,), np.dtype(np.float32))}, R,
                              N_ROWS, init)
        cold.read_bucket("v", 1)
        cold.write_bucket("v", 6, np.full((R, 2), -2.0, np.float32))
    else:
        cold = make_dense()
    man = cold.write_back(str(tmp_path / "cold"))
    back = ColdStore.read_back(str(tmp_path / "cold"))
    assert back is not None and back.is_lazy == lazy
    if lazy:
        assert man["planes"]["v"]["buckets"] == [1, 6]
        assert np.all(back.read_bucket("v", 6) == -2.0)
        with pytest.raises(RuntimeError, match="reattach_init"):
            back.read_bucket("v", 3)
        back.reattach_init(init)
        assert np.all(back.read_bucket("v", 3) == 3.0)
    else:
        for p in ("v", "w"):
            assert np.array_equal(back.dense_plane(p), cold.dense_plane(p))
    (tmp_path / "cold" / "cold_manifest.json").unlink()
    assert ColdStore.read_back(str(tmp_path / "cold")) is None


# -------------------------------------------------------------- TieredStore


def test_begin_batch_installs_and_translates_ids():
    cold = make_dense()
    store = store_of(cold)
    hot = store.init_hot()
    ids = np.array([[0, 5], [6, 1]], np.int32)  # buckets {0, 1}
    local, hot = store.begin_batch(ids, hot)
    assert local.shape == ids.shape
    want = np.stack([cold.read_bucket("v", g // R)[g % R]
                     for g in ids.ravel()])
    assert np.array_equal(gather_hot(hot, local), want)
    st = store.stats()
    assert st["misses"] == 2 and st["evictions"] == 0
    assert st["stall_ms"] > 0.0  # blocking misses are timed, not hidden


def test_capacity_guard_names_the_working_set():
    store = store_of(make_dense())
    hot = store.init_hot()
    with pytest.raises(ValueError, match="working set"):
        store.begin_batch(np.array([0, 4, 8], np.int64), hot)


def test_ids_outside_the_axis_are_refused():
    store = store_of(make_dense())
    hot = store.init_hot()
    for bad in ([N_ROWS], [-1]):
        with pytest.raises(ValueError, match="ids must lie"):
            store.begin_batch(np.array(bad, np.int64), hot)


def test_lru_eviction_flushes_dirty_rows_to_cold():
    cold = make_dense()
    store = store_of(cold)
    hot = store.init_hot()
    _, hot = store.begin_batch(np.array([0, 4], np.int64), hot)  # b0, b1
    hot["v"].add_(100.0)      # the train step's write-through, in place
    _, hot = store.begin_batch(np.array([4], np.int64), hot)
    before = cold.read_bucket("v", 0).copy()
    _, hot = store.begin_batch(np.array([8], np.int64), hot)  # forces evict
    st = store.stats()
    assert st["evictions"] == 1 and st["bytes_d2h"] > 0
    assert np.array_equal(cold.read_bucket("v", 0), before + 100.0)
    assert cold.read_bucket("v", 1)[0, 0] == 4.0


def test_stage_then_install_is_a_staged_hit():
    store = store_of(make_dense())
    hot = store.init_hot()
    assert store.stage(np.array([8, 9], np.int64)) == 1  # bucket 2
    assert store.stage(np.array([8], np.int64)) == 0     # already staged
    local, hot = store.begin_batch(np.array([8], np.int64), hot)
    st = store.stats()
    assert st["staged_hits"] == 1 and st["misses"] == 0
    assert st["hit_rate"] == 1.0
    assert gather_hot(hot, local)[0, 0] == 8.0


def test_stage_skips_resident_buckets():
    store = store_of(make_dense())
    hot = store.init_hot()
    _, hot = store.begin_batch(np.array([0], np.int64), hot)
    assert store.stage(np.array([0, 1, 2], np.int64)) == 0


def test_stale_staged_buffer_is_discarded_not_installed():
    cold = make_dense()
    store = store_of(cold)
    hot = store.init_hot()
    store.stage(np.array([12], np.int64))  # bucket 3 staged at version 0
    cold.write_bucket("v", 3, np.full((R, 2), -5.0, np.float32))
    with store._lock:
        store._version[3] = store._version.get(3, 0) + 1
    local, hot = store.begin_batch(np.array([12], np.int64), hot)
    st = store.stats()
    assert st["prefetch_stale"] == 1 and st["misses"] == 1
    assert gather_hot(hot, local)[0, 0] == -5.0


def test_eviction_invalidates_staged_buffer_by_construction():
    store = store_of(make_dense())
    hot = store.init_hot()
    _, hot = store.begin_batch(np.array([0, 4], np.int64), hot)
    hot["v"].add_(1.0)
    store.stage(np.array([8], np.int64))          # bucket 2 staged
    _, hot = store.begin_batch(np.array([8], np.int64), hot)  # evicts b0
    assert store.stats()["staged_hits"] == 1
    store.stage(np.array([0], np.int64))
    local, hot = store.begin_batch(np.array([0], np.int64), hot)
    assert gather_hot(hot, local)[0, 0] == 1.0


def test_merged_planes_is_pure_and_residency_independent():
    cold = make_dense()
    store = store_of(cold)
    hot = store.init_hot()
    _, hot = store.begin_batch(np.array([0, 4], np.int64), hot)
    hot["v"].add_(100.0)
    hot["w"].add_(1.0)
    cold_v_before = cold.dense_plane("v").copy()
    merged = store.merged_planes(hot)
    assert np.array_equal(merged["v"][:R], cold_v_before[:R] + 100.0)
    assert np.array_equal(merged["v"][2 * R:], cold_v_before[2 * R:])
    assert np.array_equal(merged["w"][:R],
                          np.arange(R, dtype=np.float32) * 10.0 + 1.0)
    assert np.array_equal(cold.dense_plane("v"), cold_v_before)
    merged2 = store.merged_planes(hot)
    assert np.array_equal(merged["v"], merged2["v"])


def test_restore_cold_resets_residency_and_invalidates_staging():
    cold = make_dense()
    store = store_of(cold)
    hot = store.init_hot()
    ptrs = {p: t.data_ptr() for p, t in hot.items()}
    _, hot = store.begin_batch(np.array([0, 4], np.int64), hot)
    store.stage(np.array([8], np.int64))
    store.restore_cold({"v": np.full((N_ROWS, 2), 9.0, np.float32),
                        "w": np.full((N_ROWS,), 9.0, np.float32)})
    assert all(bool((t == 0).all()) for t in hot.values())
    hot = store.init_hot()
    local, hot = store.begin_batch(np.array([0, 8], np.int64), hot)
    assert np.all(gather_hot(hot, local) == 9.0)
    # The hot planes keep their storage through it all.
    assert {p: t.data_ptr() for p, t in hot.items()} == ptrs


def test_tiered_store_rejects_zero_capacity():
    with pytest.raises(ValueError, match="hot_buckets"):
        store_of(make_dense(), 0)


def test_store_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    from fm_spark_tpu_torch import DeviceUnavailable

    with pytest.raises(DeviceUnavailable):
        TieredStore(make_dense(), HOT)


# ---------------------------------------------------------- BucketPrefetcher


class _ListBatches:
    def __init__(self, batches):
        self._batches = batches

    def __iter__(self):
        return iter(self._batches)


def _batch(ids):
    ids = np.asarray(ids, np.int32)
    return (ids, np.ones_like(ids, np.float32),
            np.zeros(len(ids), np.float32), np.ones(len(ids), np.float32))


def test_prefetcher_yields_batches_in_order_and_stages_ahead():
    store = store_of(make_dense())
    hot = store.init_hot()
    batches = [_batch([0, 1]), _batch([4, 5]), _batch([4, 0])]
    pf = BucketPrefetcher(_ListBatches(batches), store, depth=2)
    seen = []
    for b in pf:
        local, hot = store.begin_batch(b[0], hot)
        seen.append(b[0])
    pf.close()
    assert [tuple(s) for s in seen] == [(0, 1), (4, 5), (4, 0)]
    st = store.stats()
    assert st["misses"] == 0 and st["staged_hits"] == 2
    assert st["hit_rate"] == 1.0


def test_prefetcher_reraises_producer_exception():
    class Boom(Exception):
        pass

    def gen():
        yield _batch([0])
        raise Boom("upstream died")

    pf = BucketPrefetcher(gen(), store_of(make_dense()), depth=2)
    it = iter(pf)
    next(it)
    with pytest.raises(Boom):
        next(it)
    pf.close()


def test_prefetcher_close_is_idempotent_and_unblocks_producer():
    def gen():
        i = 0
        while True:
            yield _batch([i % N_ROWS])
            i += 1

    pf = BucketPrefetcher(gen(), store_of(make_dense()), depth=2)
    next(iter(pf))
    pf.close()
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_rejects_zero_depth():
    with pytest.raises(ValueError, match="depth"):
        BucketPrefetcher(_ListBatches([]), store_of(make_dense()), depth=0)


def test_prefetcher_state_is_the_last_consumed_cursor():
    class Counting:
        def __init__(self):
            self.i = 0

        def state(self):
            return {"i": self.i}

        def __iter__(self):
            return self

        def __next__(self):
            if self.i >= 6:
                raise StopIteration
            self.i += 1
            return _batch([(self.i * R) % N_ROWS])

    pf = BucketPrefetcher(Counting(), store_of(make_dense()), depth=3)
    assert pf.state() == {"i": 0}
    next(pf)
    next(pf)
    assert pf.state() == {"i": 2}    # never the producer's read-ahead
    pf.close()


# ------------------------------------------------------ against the JAX store


def _id_sequence(n_batches=14, seed=5):
    """Batches of 6 ids over a window of 3 of 16 buckets (R = 4) that
    drifts one bucket every two batches: churn through a hot tier of 4."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        base = (i // 2) % 13
        b = rng.integers(base, base + 3, 6)
        out.append((b * R + rng.integers(0, R, 6)).astype(np.int64))
    return out


def test_store_matches_the_jax_store_bit_for_bit():
    import jax.numpy as jnp

    from fm_spark_tpu.embed import ColdStore as JColdStore
    from fm_spark_tpu.embed import TieredStore as JTieredStore

    rng = np.random.default_rng(0)
    v = rng.standard_normal((64, 3)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    j = JTieredStore(JColdStore.dense({"v": v.copy(), "w": w.copy()}, R), 4)
    t = store_of(ColdStore.dense({"v": v.copy(), "w": w.copy()}, R), 4)
    jhot, thot = j.init_hot(), t.init_hot()
    for i, ids in enumerate(_id_sequence()):
        if i % 3 == 1:      # a staged bucket on both, before the batch
            assert j.stage(ids) == t.stage(ids)
        jl, jhot = j.begin_batch(ids, jhot)
        tl, thot = t.begin_batch(ids, thot)
        assert np.array_equal(jl, tl) and jl.dtype == tl.dtype
        assert j._bucket_in == t._bucket_in and j._version == t._version
        assert j._dirty == t._dirty and j._stamp == t._stamp
        # The same write-through on the touched rows.
        delta = np.float32(0.5 + i)
        rows = np.unique(jl)
        jhot = dict(jhot, v=jnp.asarray(jhot["v"]).at[rows].add(delta),
                    w=jnp.asarray(jhot["w"]).at[rows].add(delta))
        idx = torch.from_numpy(np.unique(tl))
        thot["v"][idx] += delta
        thot["w"][idx] += delta
    js, ts = j.stats(), t.stats()
    for k in js:
        if k != "stall_ms":
            assert js[k] == ts[k], k
    assert js["evictions"] > 0
    jm, tm = j.merged_planes(jhot), t.merged_planes(thot)
    for p in ("v", "w"):
        assert np.array_equal(np.asarray(jm[p]), tm[p]), p


def test_lazy_init_materializes_the_jax_buckets():
    from fm_spark_tpu.embed import lazy_init_fn as jax_lazy_init_fn
    from fm_spark_tpu.models import FMSpec as JFMSpec

    from fm_spark_tpu_torch.embed import lazy_init_fn
    from fm_spark_tpu_torch.models import FMSpec

    jinit = jax_lazy_init_fn(JFMSpec(num_features=4096, rank=4,
                                     init_std=0.05), 7, ftrl_seed=(0.1, 1.0))
    tinit = lazy_init_fn(FMSpec(num_features=4096, rank=4, init_std=0.05),
                         7, ftrl_seed=(0.1, 1.0))
    for plane, shape in (("v", (128, 4)), ("v_z", (128, 4)), ("w", (128,)),
                         ("v_n", (128, 4))):
        for b in (0, 3, 31):
            a = jinit(plane, b, shape, np.dtype(np.float32))
            c = tinit(plane, b, shape, np.dtype(np.float32))
            assert a.dtype == c.dtype and np.array_equal(a, c), (plane, b)
