"""The port's multi-process wire deployment (``repro_torch.core.wire``): the
paper's trust model, with passive parties as separate processes whose raw
embeddings never cross a process boundary unblinded.

The first four tests port ``tests/test_wire.py`` with spawned torch
children on the CPU. The parity tests run the reference's and the port's
``_passive_party_main`` on threads over ``multiprocessing.Pipe()`` (so no
JAX process is spawned), from the same initial weights, and compare three
rounds' losses and the round-0 transcripts: float payloads within atol
1e-5 (the two packages' float masks differ by <= 7.2e-7, their matmuls by
~1e-6 relative), int8 ring words equal. Losses agree to rtol 1e-5, as in
test_torch_protocol.py.
"""
import functools
import multiprocessing as mp
import pickle
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import party_models as jpm
from repro.core import wire as jwire
from repro_torch import checkpoint as tck
from repro_torch.configs.base import EasterConfig
from repro_torch.core import blinding
from repro_torch.core import wire as twire
from repro_torch.core.party_models import PartyArch, embed_fn, init_party
from repro_torch.core.protocol import EasterClassifier
from repro_torch.data import batch_iterator, make_dataset, vertical_partition


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager torch ops: one thread beats a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _one_thread_children(monkeypatch):
    """Spawned parties inherit this: one thread each, not every core."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _raw_embed(seed, arch, nf, x):
    """Out of band: a party's raw round-0 embedding from its seeded init."""
    p = init_party(torch.Generator().manual_seed(seed), arch, nf)
    with torch.no_grad():
        return embed_fn(p, arch, torch.from_numpy(x)).numpy()


_SPAWN_ROUNDS, _SPAWN_SEED = 15, 0


@functools.lru_cache(maxsize=None)
def _spawned(mask_mode):
    """15 rounds and an evaluation of C = 3 spawned parties, the
    transcript on: (system, losses, round-0 features, test accuracies)."""
    ds = make_dataset("mnist_like", n_train=512, n_test=128, seed=1)
    C = 3                                     # K = 2 passive => masks active
    nf = [v.shape[-1]
          for v in vertical_partition(ds.x_train, C, ds.image_hw)]
    arches = [PartyArch("mlp", (64,), (32,), 32, ds.n_classes)
              for _ in range(C)]
    sys_ = twire.WireEaster(arches, nf, ds.n_classes, lr=3e-3,
                            seed=_SPAWN_SEED, record_transcript=True,
                            mask_mode=mask_mode, device="cpu")
    sys_.start()
    try:
        it = batch_iterator(ds.x_train, ds.y_train, 128, seed=0)
        losses, xs0 = [], None
        for r in range(_SPAWN_ROUNDS):
            xb, yb = next(it)
            xs = vertical_partition(xb, C, ds.image_hw)
            xs0 = xs if xs0 is None else xs0
            losses.append(sum(sys_.round(xs, yb, r)))
        acc = sys_.evaluate(vertical_partition(ds.x_test, C, ds.image_hw),
                            ds.y_test)
    finally:
        sys_.stop()
    assert not any(p.is_alive() for p in sys_.procs)
    return sys_, losses, xs0, acc


def _trains(mask_mode):
    _, losses, _, acc = _spawned(mask_mode)
    assert losses[-1] < losses[0], losses
    assert (acc > 0.3).all(), acc


def _uplink_embeds(sys_):
    return [t for t in sys_.transcript
            if t[1] == "blinded_embed" and t[2] < _SPAWN_ROUNDS]


def test_wire_protocol_trains():
    _trains("float")


def test_wire_transcript_contains_only_blinded_embeddings():
    """Every embedding the active party sees is E_k + r_k, never a raw
    E_k: raw E_k is recomputed out of band (the passive party's weights
    are seeded), so the check is exact, not statistical."""
    seed = _SPAWN_SEED
    sys_, _, xs, _ = _spawned("float")
    C, arches, nf = sys_.C, sys_.arches, sys_.n_features
    embeds = _uplink_embeds(sys_)
    assert len(embeds) == _SPAWN_ROUNDS * (C - 1)
    round0 = [t for t in embeds if t[2] == 0]
    deltas = []
    for (_, _, _, party, blinded), k in zip(round0, range(1, C)):
        raw = _raw_embed(seed + k, arches[k], nf[k], xs[k])
        assert party == k and blinded.dtype == np.float32
        # the wire payload is NOT the raw embedding...
        assert np.max(np.abs(blinded - raw)) > 0.5, \
            "raw embedding leaked on the wire"
        deltas.append(blinded - raw)
    # ...but the masks it carries cancel pairwise (Eq. 5): it IS the
    # blinded embedding, not arbitrary corruption
    np.testing.assert_allclose(sum(deltas), np.zeros_like(deltas[0]),
                               atol=1e-4)
    # and nothing else on the uplink is embedding-shaped raw data
    kinds = {t[1] for t in sys_.transcript if t[0] == "passive->active"}
    assert kinds == {"blinded_embed", "prediction"}


def test_wire_int8_protocol_trains():
    """The full multi-process protocol still trains when every leg ships
    packed int8 ring words."""
    _trains("int8")


def test_wire_int8_transcript_is_packed_ring_words():
    """The int8 uplink carries ONLY packed int32 ring words (+ the scalar
    amax of phase 1 and int8-framed predictions), and the unpacked bytes
    look ring-uniform (the masks dominate)."""
    seed = _SPAWN_SEED
    sys_, _, xs, _ = _spawned("int8")
    C, arches, nf = sys_.C, sys_.arches, sys_.n_features
    kinds = {t[1] for t in sys_.transcript if t[0] == "passive->active"}
    assert kinds == {"embed_amax", "blinded_embed", "prediction"}
    embeds = _uplink_embeds(sys_)
    assert len(embeds) == _SPAWN_ROUNDS * (C - 1)
    n_elts = len(xs[0]) * arches[1].d_embed
    for t in sys_.transcript:
        if t[0] == "passive->active" and t[1] != "embed_amax":
            assert t[4].dtype == np.dtype("<i4"), t[:4]
    for (_, _, _, party, payload) in embeds:
        assert payload.size == (n_elts + 3) // 4
        q = blinding.unpack_int8_words(payload, (n_elts,))
        assert q.min() < -100 and q.max() > 100
        hist, _ = np.histogram(q.astype(np.int64), bins=4,
                               range=(-128, 128))
        assert (hist > n_elts // 16).all(), hist
    # out of band: the masks cancel across the round-0 uplink mod 256, so
    # the pair of payloads sums to the quantized embeddings
    round0 = [t for t in embeds if t[2] == 0]
    q_sum = sum(blinding.unpack_int8_words(t[4], (n_elts,)).astype(np.int64)
                for t in round0)
    raw_sum = sum(_raw_embed(seed + k, arches[k], nf[k], xs[k]).reshape(-1)
                  for k in range(1, C))
    amaxes = [float(t[4]) for t in sys_.transcript
              if t[1] == "embed_amax" and t[2] == 0]
    amax_a = float(np.abs(_raw_embed(seed, arches[0], nf[0], xs[0])).max())
    scale = float(blinding.ring_scale(max([amax_a] + amaxes), C, "int8"))
    wrapped = ((q_sum + 128) % 256) - 128        # ring sum of the K rows
    np.testing.assert_allclose(wrapped / scale, raw_sum,
                               atol=0.5 * (C - 1) / scale + 1e-6)


# ---------------------------------------------------------------------------
# the reference's and the port's parties on threads, same weights
# ---------------------------------------------------------------------------

_SEED, _LR, _ROUNDS = 0, 3e-3, 3


def _run(target, conn, *args):
    """A party on a thread; its pipe end closes when it returns or fails,
    so the orchestrator's receive ends instead of blocking."""
    try:
        target(conn, *args)
    finally:
        conn.close()


def _spawn_threads(sys_, target, extra):
    threads = []
    for k in range(sys_.K):
        parent, child = mp.Pipe()
        t = threading.Thread(
            target=_run, daemon=True,
            args=(target, child, k, pickle.dumps(sys_.arches[k + 1]),
                  sys_.n_features[k + 1], sys_.lr, sys_.seed + k + 1,
                  sys_.mask_mode) + extra(k))
        t.start()
        sys_.conns.append(parent)
        threads.append(t)
    return threads


def _stop_threads(sys_, threads):
    for c in sys_.conns:
        c.send(("stop",))
        assert c.poll(30)
        c.recv()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()


def _parity_data():
    ds = make_dataset("mnist_like", n_train=256, n_test=64, seed=2)
    C = 3
    nf = [v.shape[-1]
          for v in vertical_partition(ds.x_train, C, ds.image_hw)]
    jarches = [jpm.PartyArch("mlp", (32,), (16,), 24, ds.n_classes)
               for _ in range(C)]
    it = batch_iterator(ds.x_train, ds.y_train, 64, seed=0)
    batches = []
    for _ in range(_ROUNDS):
        xb, yb = next(it)
        batches.append((vertical_partition(xb, C, ds.image_hw), yb))
    return ds.n_classes, nf, jarches, batches


@functools.lru_cache(maxsize=None)
def _runs(mode):
    """(reference losses, port losses, reference transcript, port
    transcript, port system, initial weights, batches) of ``_ROUNDS``
    rounds each, computed once per wire."""
    n_cls, nf, jarches, batches = _parity_data()
    C = len(jarches)
    init = [jax.tree.map(np.asarray, jpm.init_party(
        jax.random.PRNGKey(_SEED + k), jarches[k], nf[k])) for k in range(C)]
    # the reference: its start() with the parties on threads
    jsys = jwire.WireEaster(jarches, nf, n_cls, lr=_LR, seed=_SEED,
                            record_transcript=True, mask_mode=mode)
    jthreads = _spawn_threads(jsys, jwire._passive_party_main,
                              lambda k: ())
    try:
        # the reference's key ceremony (src/repro/core/wire.py:222-230)
        pks = {}
        for k, c in enumerate(jsys.conns):
            c.send(("pubkey",))
            _, pk = c.recv()
            pks[k] = pk
        for k, c in enumerate(jsys.conns):
            others = {j: pk for j, pk in pks.items() if j != k}
            c.send(("setup", others, jsys.C))
        jl = [jsys.round(xs, y, r) for r, (xs, y) in enumerate(batches)]
    finally:
        _stop_threads(jsys, jthreads)
    tarches = [PartyArch(**vars(a)) for a in jarches]
    tsys = twire.WireEaster(tarches, nf, n_cls, lr=_LR, seed=_SEED,
                            record_transcript=True, mask_mode=mode,
                            device="cpu", init_params=init)
    tthreads = _spawn_threads(tsys, twire._passive_party_main,
                              lambda k: ("cpu", init[k + 1]))
    tsys.procs = tthreads
    try:
        tsys._key_ceremony()
        tl = [tsys.round(xs, y, r) for r, (xs, y) in enumerate(batches)]
    finally:
        _stop_threads(tsys, tthreads)
    return jl, tl, jsys.transcript, tsys.transcript, tsys, init, batches


def _ring_steps(a, b):
    """Elementwise distance in Z_2^8 between two packed-word payloads."""
    ring = lambda w: np.ascontiguousarray(np.asarray(w, "<i4")).view(
        np.int8).astype(np.int16)
    return np.abs((ring(a) - ring(b) + 128) % 256 - 128)


# where a codec input sits on a rounding boundary, the two packages' values
# (~1e-7 apart) may land one ring step apart. One step of party k's
# prediction leg is max|R_k| / 126.5 and moves a mean loss over B rows by
# at most that over B; max|R_k| <= 2 at these weights (the float run
# checks it), so each such element is allowed 2 / (126.5 B) in the losses
# from its round on
_MAX_ABS_R = 2.0


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_wire_rounds_match_reference_on_threads(mode):
    jl, tl, jt, tt, _, _, batches = _runs(mode)
    B = len(batches[0][1])
    assert [t[:4] for t in tt] == [t[:4] for t in jt]
    steps = np.zeros(np.asarray(jl).shape)  # one-step elements so far
    for (d, kind, r, party, a), (_, _, _, _, b) in zip(tt, jt):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (d, kind, party)
        if a.dtype == np.dtype("<i4"):        # packed int8 ring words
            diff = _ring_steps(a, b)
            assert diff.max() <= 1, (kind, r, party, diff.max())
            n = int(diff.sum())
            if n:
                print(f"int8 {kind} round {r} party {party}: {n} of "
                      f"{diff.size} ring elements one step apart")
                # an embedding leg reaches every party's loss
                whose = (party if kind in ("prediction", "loss_grad")
                         else slice(None))
                steps[r:, whose] += n
        elif r == 0:
            np.testing.assert_allclose(a, b, rtol=1e-6 if a.ndim == 0
                                       else 0, atol=0 if a.ndim == 0
                                       else 1e-5, err_msg=f"{kind} {party}")
        if mode == "float" and kind == "prediction":
            assert np.abs(a).max() <= _MAX_ABS_R
    err = np.abs(np.asarray(tl) - np.asarray(jl))
    allowed = 1e-5 * np.abs(np.asarray(jl)) + steps * _MAX_ABS_R / (126.5 * B)
    assert (err <= allowed).all(), (err, allowed)


def test_wire_float_bytes_equal_classifier_bytes_per_round():
    """The float transcript's bytes in a round, the global embedding
    counted once per passive party (the active party sends it to each),
    are EasterClassifier's bytes_per_round."""
    _, _, _, tt, tsys, _, batches = _runs("float")
    B = len(batches[0][1])
    n = sum(t[4].nbytes * (tsys.K if t[1] == "global_embed" else 1)
            for t in tt if t[2] == 0)
    cls = EasterClassifier(
        EasterConfig(num_passive=tsys.K, d_embed=tsys.arches[0].d_embed),
        tsys.arches, tsys.n_features, device="cpu")
    assert n == cls.bytes_per_round(B) == 2 * tsys.K * B * 4 * (
        tsys.arches[0].d_embed + tsys.n_classes)


def test_wire_round_matches_in_process_classifier():
    """Round 0 on the wire equals the in-process EasterClassifier's round
    0 (loop engine, float wire) from the same weights: the masks differ
    (each draws its own keys) but cancel, so the losses agree."""
    _, tl, _, _, tsys, init, batches = _runs("float")
    cls = EasterClassifier(
        EasterConfig(num_passive=tsys.K, d_embed=tsys.arches[0].d_embed),
        tsys.arches, tsys.n_features, engine="loop", device="cpu")
    xs, y = batches[0]
    _, per = cls.loss_fn(tck.params_from_numpy(init, "cpu"),
                         [torch.from_numpy(x) for x in xs],
                         torch.from_numpy(y), cls.masks(len(y), 0))
    np.testing.assert_allclose(tl[0], per.detach().numpy(), rtol=1e-5)
