"""The port's encoder-decoder (whisper-small) and vision (qwen2-vl-7b)
families against the JAX reference, on the CPU: the fixed sinusoids and
M-RoPE, the encoder and its cross K/V, ``apply_lm`` with every frontend
input, EasterLM's ``encoder_kv``, ``prefill`` + ``serve_tokens`` with a
per-party ``fe_list``, and ``loss_fn`` on a batch's ``*_embed`` keys.

The models run the smoke variants in float32 (whisper: 2 encoder and 2
decoder layers over 16 frames; qwen2-vl: 8 patch positions, M-RoPE
sections (8, 12, 12)), EasterLM with two passive parties; the weights
are drawn once from a seeded torch generator in the reference's tree
layout and cross as numpy arrays (``load_params`` on the port's side);
tokens and frontend inputs come from numpy seeds. Each reference object
is built and run once per module (jitted: that compiles faster than it
runs eagerly), and both port engines are held against it.

Tolerances: rtol 1e-4 / atol 1e-5 (float32; the two frameworks sum in
other orders), logits at atol 1e-5 of their largest |value| as in
test_torch_lm.py; M-RoPE within 1e-6 and the sinusoids within 1e-6 plus
two float32 ulps of the angle (``_angle_close``); greedy tokens and the
int8 wire's integers exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core.easter_lm import EasterLM as JLM
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.build import frontend_inputs as j_frontend_inputs
from repro_torch import checkpoint
from repro_torch.configs import base as tcfg
from repro_torch.core import decode, train_loop
from repro_torch.core.easter_lm import EasterLM as TLM
from repro_torch.core.party_engine import stack_views
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import build as tbuild
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves

ARCHS = ("whisper-small", "qwen2-vl-7b")
RTOL, ATOL = 1e-4, 1e-5
B, P, N_NEW = 2, 12, 3          # lanes, prompt tokens, greedy new tokens
# two passive parties (C = 3): a blinded group of two; the reference's
# EasterLM with three compiles ~30% longer
K = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager torch ops: one thread beats a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _scaled_close(got, want):
    """Logits: atol 1e-5 of their largest |value| (tied unit-normal rows
    put them near |100|)."""
    _close(got, want, atol=ATOL * float(np.abs(_np(want)).max()))


def _trees_close(got, want):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b))
        if np.issubdtype(np.asarray(b).dtype, np.integer):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(arch):
    return (jcfg.smoke_variant(jcfg.get_config(arch)),
            tcfg.smoke_variant(tcfg.get_config(arch)))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """EasterLM weights in the reference's tree layout as numpy arrays
    (drawn by the port from a seeded generator: the reference's jitted
    init_params compiles for ~10 s); ``["parties"][0]["backbone"]`` is
    an init_lm tree."""
    ts = _tsys(arch, engine="loop")
    tree = ts.export_params(ts.init_params(torch.Generator().manual_seed(0)))
    want = jax.eval_shape(_jsys(arch).init_params, jax.random.PRNGKey(0))
    assert jax.tree.map(lambda s: (s.shape, s.dtype), want) == \
        jax.tree.map(lambda a: (a.shape, a.dtype), tree)
    return tree


def _jsys(arch, wire="float", engine="vectorized"):
    return JLM(_cfgs(arch)[0], jcfg.EasterConfig(num_passive=K,
                                                 mask_mode=wire),
               engine=engine)


def _tsys(arch, wire="float", engine="vectorized"):
    return TLM(_cfgs(arch)[1], tcfg.EasterConfig(num_passive=K,
                                                 mask_mode=wire),
               engine=engine, device="cpu")


def _backbone(arch):
    """The active party's backbone tree and its configs (tied
    embeddings, as EasterLM makes every party's)."""
    return (_ref_params(arch)["parties"][0]["backbone"],) + tuple(
        dataclasses.replace(c, tie_embeddings=True) for c in _cfgs(arch))


@functools.lru_cache(maxsize=None)
def _inputs(arch):
    """Tokens (B, P) and the stubbed frontend input of the family."""
    jc = _cfgs(arch)[0]
    rng = np.random.default_rng(11)
    tok = rng.integers(0, jc.vocab_size, (B, P)).astype(np.int32)
    n = jc.n_audio_frames if jc.family == "encdec" else jc.n_vision_tokens
    fe = rng.normal(size=(B, n, jc.d_model)).astype(np.float32)
    key = "audio_embed" if jc.family == "encdec" else "vision_embed"
    return tok, {key: fe}


def _mrope_pos(S, offset=0, seed=3):
    """(3, B, S) temporal / height / width ids: a patch grid then text."""
    rng = np.random.default_rng(seed)
    base = np.arange(S, dtype=np.int32) + offset
    return np.stack([base, base // 3 + rng.integers(0, 2),
                     base % 5 + rng.integers(0, 2)])[:, None].repeat(B, 1)


# ---------------------------------------------------------------------------
# configs, sinusoids, M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_frontend_inputs_match_reference(arch):
    j, t = jcfg.get_config(arch), tcfg.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    jc, tc = _cfgs(arch)
    want = jax.eval_shape(lambda k: j_frontend_inputs(jc, 3, k),
                          jax.random.PRNGKey(0))
    got = tbuild.frontend_inputs(tc, 3, torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} == \
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in got.items()}
    assert tbuild.frontend_inputs(tcfg.smoke_variant(tcfg.get_config(
        "qwen2.5-3b")), 3, torch.Generator()) == {}


def _angle_close(got, want, ang):
    """Within 1e-6 plus two float32 ulps of the angle: the packages' pow
    (10000 ** (2i / d), theta ** (2i / hd)) may differ in its last bit
    (XLA's eager and jitted pow differ from each other there), which
    moves sin and cos of an angle a by up to a * 2^-23."""
    err = np.abs(_np(got) - _np(want))
    assert np.all(err <= 1e-6 + 2.0 ** -22 * np.abs(ang)), err.max()


def test_sinusoid_rows_are_the_reference_table_rows():
    """Trap: the reference builds the whole 32,776-row float32 table on
    every apply_lm call; the port computes only the gathered rows, bit
    for bit the rows of its own table, which holds the reference's."""
    d = 64
    pos = np.array([[0, 1, 7, 1499], [32_775, 100, 4096, 2]])
    table = TT._sinusoid(32_776, d, torch.float32)
    assert torch.equal(TT._sinusoid_rows(_t(pos), d), table[_t(pos)])
    ang = np.arange(32_776)[:, None] * np.ones((1, d))
    ang[:, :d // 2] /= 10000.0 ** (2 * np.arange(d // 2) / d)
    ang[:, d // 2:] = ang[:, :d // 2]
    _angle_close(table, JT._sinusoid(32_776, d, jnp.float32), ang)
    d = 768
    ang = np.arange(1500)[:, None] / 10000.0 ** (2 * np.arange(d // 2) / d)
    _angle_close(TT._sinusoid(1500, d, torch.float32),
                 JT._sinusoid(1500, d, jnp.float32), np.tile(ang, 2))


@pytest.mark.parametrize("hd,sections", [(128, (16, 24, 24)),
                                         (64, (8, 12, 12))])
def test_mrope_cos_sin_matches(hd, sections):
    pos = np.random.default_rng(hd).integers(0, 3000, (3, 2, 9))
    want = JL.mrope_cos_sin(jnp.asarray(pos), hd, 1e6, sections)
    got = TL.mrope_cos_sin(_t(pos), hd, 1e6, sections)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 9, hd // 2)
        _close(g, w, 0, 1e-6)
    with pytest.raises(ValueError, match="sections"):
        TL.mrope_cos_sin(_t(pos), hd, 1e6, (8, 8, 8))


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------


def test_encode_and_encoder_kv_match():
    jp, jc, tc = _backbone("whisper-small")
    tp = checkpoint.params_from_numpy(jp, "cpu", False)
    audio = _inputs("whisper-small")[1]["audio_embed"]

    def ref(p, a):
        enc = JT.encode(p, a, jc)
        return (enc,) + JT._encoder_kv(p, enc, jc)

    j_enc, j_k, j_v = jax.jit(ref)(jax.tree.map(jnp.asarray, jp),
                                   jnp.asarray(audio))
    with torch.no_grad():
        enc = TT.encode(tp, _t(audio), tc)
        k, v = TT._encoder_kv(tp, enc, tc)
    _close(enc, j_enc)
    assert tuple(k.shape) == (tc.n_layers, B, tc.n_audio_frames,
                              tc.n_kv_heads, tc.resolved_head_dim)
    _close(k, j_k)
    _close(v, j_v)


@functools.lru_cache(maxsize=None)
def _ref_lm(arch):
    """The reference's apply_lm (jitted once): the full forward over P
    tokens with the frontend input; a prefill of P - 1 tokens into
    per-lane caches (qwen2-vl with M-RoPE ids); one decode step (whisper
    from the precomputed enc_kv, qwen2-vl with its M-RoPE ids)."""
    jp, jc, _ = _backbone(arch)
    tok, fe = _inputs(arch)
    fe = {k: jnp.asarray(v) for k, v in fe.items()}
    if jc.family == "vlm":
        fe["mrope_pos"] = jnp.asarray(_mrope_pos(P - 1))
    pos = jnp.full((B, 1), P - 1, jnp.int32)

    def run(jp, tok, fe):
        if jc.family == "vlm":
            dec_fe = {"mrope_pos": jnp.asarray(_mrope_pos(1, P - 1))}
        else:
            dec_fe = {"enc_kv": JT._encoder_kv(
                jp, JT.encode(jp, fe["audio_embed"], jc), jc)}
        full, _, _ = JT.apply_lm(jp, tok, jc, **{
            k: v for k, v in fe.items() if k != "mrope_pos"})
        caches = JT.init_cache(jc, B, P + 2, per_lane=True)
        h, caches, _ = JT.apply_lm(jp, tok[:, :-1], jc, caches=caches,
                                   return_hidden=True, **fe)
        dec, caches2, _ = JT.apply_lm(jp, tok[:, -1:], jc, caches=caches,
                                      pos_offset=pos, **dec_fe)
        return dict(full=full, h=h, caches=caches, dec=dec,
                    caches2=caches2, dec_fe=dec_fe)

    out = jax.jit(run)(jax.tree.map(jnp.asarray, jp), jnp.asarray(tok), fe)
    return jax.tree.map(np.asarray, dict(out, fe=fe))


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_lm_with_frontends_matches(arch):
    """The full forward (whisper: audio_embed encoded inside; qwen2-vl:
    the patch insert), a prefill with caches (qwen2-vl with M-RoPE) and a
    decode step (whisper from enc_kv, qwen2-vl with M-RoPE ids)."""
    jp, _, tc = _backbone(arch)
    r = _ref_lm(arch)
    tp = checkpoint.params_from_numpy(jp, "cpu", False)
    tok = _inputs(arch)[0]
    fe = {k: _t(v) for k, v in r["fe"].items()}
    with torch.no_grad():
        full, _, _ = tbuild.build(tc).apply(
            tp, _t(tok), **{k: v for k, v in fe.items() if k != "mrope_pos"})
        caches = TT.init_cache(tc, B, P + 2, per_lane=True)
        h, caches, _ = TT.apply_lm(tp, _t(tok[:, :-1]), tc, caches=caches,
                                   return_hidden=True, **fe)
        dec_fe = {k: (tuple(_t(a) for a in v) if isinstance(v, tuple)
                      else _t(v)) for k, v in r["dec_fe"].items()}
        dec, caches2, _ = TT.apply_lm(
            tp, _t(tok[:, -1:]), tc, caches=caches,
            pos_offset=_t(np.full((B, 1), P - 1, np.int32)), **dec_fe)
    _scaled_close(full, r["full"])
    _close(h, r["h"])
    _trees_close(caches, r["caches"])
    _scaled_close(dec, r["dec"])
    _trees_close(caches2, r["caches2"])


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_matches_full(arch):
    """The port's counterpart of test_models_smoke.py's: the last logits
    of a full forward equal a prefill then one decode step, each given the
    frontend inputs (whisper re-encodes the audio every call; qwen2-vl's
    decode step is shorter than the patches and skips the insert)."""
    tc = _cfgs(arch)[1]
    fns = tbuild.build(tc)
    gen = torch.Generator().manual_seed(1)
    params = fns.init(gen)
    S = 16
    toks = torch.randint(0, tc.vocab_size, (2, S), generator=gen)
    fe = tbuild.frontend_inputs(tc, 2, gen)
    with torch.no_grad():
        full, _, _ = fns.apply(params, toks, **fe)
        caches = fns.init_cache(2, S)
        _, caches, _ = fns.apply(params, toks[:, :S - 1], caches=caches,
                                 **fe)
        dec, _, _ = fns.apply(params, toks[:, S - 1:], caches=caches,
                              pos_offset=S - 1, **fe)
    np.testing.assert_allclose(full[:, -1].numpy(), dec[:, 0].numpy(),
                               atol=2e-3)


def test_gqa_group_of_seven_matches():
    """qwen2-vl's 28/4 heads put 7 query heads on each kv head (query head
    h reads kv head h // 7): a self-attention layer at 28/4 heads of 32
    with M-RoPE cos/sin (sections (4, 6, 6)) and a prompt cache, and the
    flash kernel's plain version at 28/4/128, against the reference."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(4)
    p = TL.init_attention(gen, 64, 28, 4, 32, True, torch.float32)
    jp = jax.tree.map(jnp.asarray, checkpoint.params_to_numpy(p))
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, P, 64)).astype(np.float32)
    pos = _mrope_pos(P)
    kw = dict(n_heads=28, n_kv_heads=4, head_dim=32)
    jcache = {"k": jnp.zeros((B, P + 1, 4, 32)),
              "v": jnp.zeros((B, P + 1, 4, 32)),
              "idx": jnp.zeros((), jnp.int32)}

    def ref(p, x, pos, cache):
        c, s = JL.mrope_cos_sin(pos, 32, 1e6, (4, 6, 6))
        return JL.self_attention(p, x, cos=c, sin=s, cache=cache, **kw)

    want, want_c = jax.jit(ref)(jp, jnp.asarray(x), jnp.asarray(pos),
                                jcache)
    tc, ts_ = TL.mrope_cos_sin(_t(pos), 32, 1e6, (4, 6, 6))
    with torch.no_grad():
        got, got_c = TL.self_attention(
            p, _t(x), cos=tc, sin=ts_,
            cache={k: _t(np.asarray(v)) for k, v in jcache.items()}, **kw)
    _close(got, want)
    _trees_close(got_c, want_c)
    q, k, v = (rng.normal(size=(1, 20, h, 128)).astype(np.float32)
               for h in (28, 4, 4))
    _close(ops.flash_attention(_t(q), _t(k), _t(v), causal=True),
           jref.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True), 1e-5, 1e-6)


def test_xattn_block_kind_matches_reference_layout():
    """init_block's "xattn" kind (public, never in a stack plan) has the
    reference's tree, and applies as "attn"."""
    jc, tc = _cfgs("whisper-small")
    want = jax.eval_shape(lambda k: JT.init_block(k, jc, "xattn"),
                          jax.random.PRNGKey(0))
    p = TT.init_block(torch.Generator().manual_seed(0), tc, "xattn")
    assert [tuple(a.shape) for a in tree_leaves(p)] == \
        [tuple(a.shape) for a in jax.tree.leaves(want)]
    x = torch.randn((1, 5, tc.d_model), generator=torch.Generator())
    with torch.no_grad():
        a = TT.apply_block(p, x, cfg=tc, kind="xattn", cos=None, sin=None,
                           cache=None)[0]
        b = TT.apply_block(p, x, cfg=tc, kind="attn", cos=None, sin=None,
                           cache=None)[0]
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="block kind"):
        TT.init_block(torch.Generator(), tc, "conv")
    with pytest.raises(ValueError, match="family"):
        TT._check_family(dataclasses.replace(tc, family="rnn"))


# ---------------------------------------------------------------------------
# EasterLM serving
# ---------------------------------------------------------------------------


def _fe_list(jsys_or_tsys, arch, params, torch_side):
    """The per-party frontend inputs of a prefill: whisper's encoder_kv,
    qwen2-vl's patch embeddings (every party the same image)."""
    _, fe = _inputs(arch)
    conv = _t if torch_side else jnp.asarray
    if "audio_embed" in fe:
        return jsys_or_tsys.encoder_kv(params, conv(fe["audio_embed"]))
    return [{"vision_embed": conv(fe["vision_embed"])}
            for _ in range(jsys_or_tsys.C)]


@functools.lru_cache(maxsize=None)
def _ref_fe_list(arch):
    js = _jsys(arch, engine="loop")
    params = jax.tree.map(jnp.asarray, _ref_params(arch))
    if arch == "whisper-small":
        audio = jnp.asarray(_inputs(arch)[1]["audio_embed"])
        return jax.jit(js.encoder_kv)(params, audio)
    return _fe_list(js, arch, params, False)


@functools.lru_cache(maxsize=None)
def _ref_served(arch, wire):
    """One reference run per (arch, wire), on its loop engine (the
    reference's oracle, which its tests hold its vectorized engine to;
    it compiles ~30% faster): encoder_kv (whisper), a blinded prefill of
    P - 1 tokens with the fe_list, then N_NEW greedy serve_step rounds
    with it (one jitted step driven in a loop: the reference's own tests
    hold its fused serve_tokens to that loop bit for bit)."""
    js = _jsys(arch, wire, engine="loop")
    params = jax.tree.map(jnp.asarray, _ref_params(arch))
    tok = _inputs(arch)[0]
    seeds = js.mask_seeds()
    fe_list = _ref_fe_list(arch)
    E, caches = jax.jit(lambda p, t, c, f: js.prefill(
        p, t, c, fe_list=f, seeds=seeds, round_idx=3))(
        params, jnp.asarray(tok[:, :-1]), js.init_caches(B, P + N_NEW),
        fe_list)
    step = jax.jit(lambda p, t, c, pos, f: js.serve_step(
        p, t, c, pos, seeds, fe_list=f))
    nxt, out, logits = jnp.asarray(tok[:, -1:]), [], []
    for i in range(N_NEW):
        lg, caches = step(params, nxt, caches, jnp.int32(P - 1 + i), fe_list)
        nxt = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
        out.append(nxt)
        logits.append(lg[:, -1])
    return jax.tree.map(np.asarray, dict(
        fe_list=fe_list, E=E, out=jnp.concatenate(out, 1),
        logits=jnp.stack(logits, 1), caches=caches))


@pytest.mark.parametrize("engine", ["vectorized", "loop"])
@pytest.mark.parametrize("arch,wire", [("whisper-small", "float"),
                                       ("whisper-small", "int8"),
                                       ("qwen2-vl-7b", "float")])
def test_prefill_and_serve_tokens_match(arch, wire, engine):
    """encoder_kv (whisper), prefill(fe_list) and serve_tokens(fe_list):
    the cross K/V, the prefill embeddings, every round's logits, the
    greedy tokens and the caches; whisper also on the int8 ring wire."""
    r = _ref_served(arch, wire)
    ts = _tsys(arch, wire, engine)
    params = ts.load_params(_ref_params(arch))
    tok = _inputs(arch)[0]
    seeds = ts.mask_seeds()
    fe_list = _fe_list(ts, arch, params, True)
    _trees_close(fe_list, r["fe_list"])
    E, caches = ts.prefill(params, _t(tok[:, :-1]),
                           ts.init_caches(B, P + N_NEW), fe_list=fe_list,
                           seeds=seeds, round_idx=3)
    _close(E, r["E"])
    out, caches, _, _, logits = decode.serve_tokens(
        ts, params, _t(tok[:, -1:]), caches, P - 1, N_NEW, seeds,
        fe_list=fe_list, return_logits=True)
    _scaled_close(logits, r["logits"])
    np.testing.assert_array_equal(out.numpy(), r["out"])
    _trees_close(caches, r["caches"])


def test_encoder_kv_group_is_one_layer_major_tensor():
    """Trap: restacking the passive group's cross K/V every round. The
    passive entries of encoder_kv are views into one (K, L, ...) tensor
    whose layer slices across the group, [:, l], are contiguous, so the
    grouped round's stack_views copies nothing; a shared input (the same
    patch embeddings for every party) stacks as a view too, and anything
    else is copied."""
    ts = _tsys("whisper-small")
    params = ts.load_params(_ref_params("whisper-small"))
    fe_list = _fe_list(ts, "whisper-small", params, True)
    k0 = fe_list[1]["enc_kv"][0]
    sk, sv = stack_views(fe_list[1:])["enc_kv"]
    assert sk.untyped_storage().data_ptr() == k0.untyped_storage().data_ptr()
    assert tuple(sk.shape) == (K,) + tuple(k0.shape)
    for l in range(sk.shape[1]):
        assert sk[:, l].is_contiguous() and sv[:, l].is_contiguous()
    for i, f in enumerate(fe_list[1:]):
        assert torch.equal(sk[i], f["enc_kv"][0])
    x = torch.randn(2, 3)
    shared = stack_views([{"x": x}] * 3)["x"]
    assert shared.stride(0) == 0 and shared.data_ptr() == x.data_ptr()
    loose = stack_views([{"x": torch.randn(2, 3)} for _ in range(3)])["x"]
    assert loose.is_contiguous() and tuple(loose.shape) == (3, 2, 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_both_embedding_routes_apply_the_frontend(arch):
    """Trap: the grouped passives enter through embed_grouped and
    _embed_from, not apply_lm; the patch insert and the decoder's
    sinusoidal positions sit in apply_hidden, which both routes pass. The
    serving group (one vmap) and the training group (group=True) each
    equal the parties one by one; without the frontend input (qwen2-vl)
    or with another (whisper) the group's embeddings differ."""
    ts = _tsys(arch)
    params = ts.load_params(_ref_params(arch))
    tok = _t(_inputs(arch)[0])
    fe_list = _fe_list(ts, arch, params, True)
    caches = ts.init_caches(B, P)
    with torch.no_grad():
        E_p, _ = ts._passive_embed_grouped(params, tok, caches, 0, -1,
                                           fe_list)
        for k in range(1, ts.C):
            E_k, _, _ = ts.local_embed(params["parties"][k],
                                       ts.party_cfgs[k], tok,
                                       caches=caches[k], **fe_list[k])
            _close(E_p[k - 1], E_k, 1e-5, 1e-6)
        other = ([{"vision_embed": torch.zeros_like(
            fe_list[0]["vision_embed"])}] * ts.C
            if "vision_embed" in fe_list[0] else ts.encoder_kv(
                params, torch.zeros_like(_t(_inputs(arch)[1][
                    "audio_embed"]))))
        E_o, _ = ts._passive_embed_grouped(params, tok, caches, 0, -1, other)
        assert not torch.allclose(E_o, E_p, atol=1e-3)
        fe = {k: _t(v) for k, v in _inputs(arch)[1].items()}
        sp = ts._passive_stack(params)
        h_g, _, _ = TT.apply_hidden(
            sp["backbone"], TL.embed_grouped(sp["backbone"]["embed"][
                "table"], tok), ts.party_cfgs[1], return_hidden=True,
            training=True, group=True, **fe)
        for k in range(1, ts.C):
            h_k, _, _ = TT.apply_lm(params["parties"][k]["backbone"], tok,
                                    ts.party_cfgs[k], return_hidden=True,
                                    training=True, **fe)
            _close(h_g[k - 1], h_k, 1e-5, 1e-6)


def test_patch_insert_needs_a_prompt_as_long_as_the_patches():
    """Trap: the patches go in only when S >= n_vision_tokens; a serving
    prefill is prompt[:-1], so a prompt of exactly n_vision_tokens gets no
    patches (as in the reference) and one token more does."""
    tc = _cfgs("qwen2-vl-7b")[1]
    ts = _tsys("qwen2-vl-7b")
    params = ts.load_params(_ref_params("qwen2-vl-7b"))
    n = tc.n_vision_tokens
    gen = torch.Generator().manual_seed(2)
    tok = torch.randint(0, tc.vocab_size, (1, n + 1), generator=gen)
    ves = [tbuild.frontend_inputs(tc, 1, gen) for _ in range(2)]

    def E(prompt, fe):
        return ts.prefill(params, prompt[:, :-1], ts.init_caches(1, n + 2),
                          fe_list=[fe] * ts.C)[0]

    short = [E(tok[:, :n], fe) for fe in ves]
    assert torch.equal(short[0], short[1])
    long_ = [E(tok, fe) for fe in ves]
    assert not torch.allclose(long_[0][:, :n], long_[1][:, :n], atol=1e-3)


# ---------------------------------------------------------------------------
# EasterLM training
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_grads(arch):
    """The reference's jitted value_and_grad of loss_fn."""
    js = _jsys(arch)
    tok, fe = _inputs(arch)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1), **fe}
    seeds = js.mask_seeds()
    fn = jax.jit(lambda p, b: jax.value_and_grad(js.loss_fn, has_aux=True)(
        p, b, jnp.int32(3), seeds))
    (total, per), g = fn(jax.tree.map(jnp.asarray, _ref_params(arch)),
                         jax.tree.map(jnp.asarray, batch))
    return batch, np.asarray(total), np.asarray(per), jax.tree.map(
        np.asarray, g)


@pytest.mark.parametrize("engine", ["vectorized", "loop"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_with_frontends_match(arch, engine):
    """loss_fn with audio_embed / vision_embed in the batch: losses and
    every party's gradients (the encoder's and the cross-attention's
    included)."""
    batch, j_total, j_per, j_g = _ref_grads(arch)
    ts = _tsys(arch, engine=engine)
    params = ts.load_params(_ref_params(arch))
    total, per, g = train_loop.loss_and_grads(ts, params, batch, 3,
                                              ts.mask_seeds())
    _close(per, j_per)
    _close(total, j_total)
    _trees_close(g, j_g)


# ---------------------------------------------------------------------------
# weights, checkpoints, launchers
# ---------------------------------------------------------------------------


def test_passive_stack_lays_the_encoder_and_cross_attention_layer_major(
        tmp_path):
    """The stacked passive group carries the encoder blocks and the
    cross-attention leaves layer-major (a[:, l] contiguous); the draw is
    the stacked per-party draw bit for bit; save / restore round-trip
    every new leaf in the reference's tree layout."""
    tc = _cfgs("whisper-small")[1]
    ts = TLM(tc, tcfg.EasterConfig(), device="cpu")
    params = ts.init_params(torch.Generator().manual_seed(3))
    bb = ts._passive_stack(params)["backbone"]
    for a in tree_leaves([bb["encoder"]["blocks"], bb["xattn"]]):
        assert all(a[:, l].is_contiguous() for l in range(a.shape[1]))
    assert all(a.is_contiguous() for a in tree_leaves(bb["encoder"]["norm"]))
    gen = torch.Generator().manual_seed(3)
    parties = [ts.init_party(gen, c) for c in ts.party_cfgs]
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(params["parties"]), tree_leaves(parties)))
    want = jax.eval_shape(JLM(_cfgs("whisper-small")[0],
                              jcfg.EasterConfig()).init_params,
                          jax.random.PRNGKey(0))
    tree = ts.export_params(params)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    path = checkpoint.save(str(tmp_path / "w.npz"), {"parties":
                                                    params["parties"]}, 5)
    back, step = checkpoint.restore(path, {"parties": params["parties"]})
    assert step == 5 and all(torch.equal(x, y) for x, y in zip(
        tree_leaves(back), tree_leaves(params["parties"])))


def test_launchers_on_both_families(tmp_path, monkeypatch, capsys):
    """qwen2-vl-7b serves and trains as a text model (the launchers make
    no patches, as the reference's); whisper-small needs audio that the
    launchers do not invent, and raises a clear error where the
    reference's apply_lm asserts."""
    serve_cli.main(["--arch", "qwen2-vl-7b", "--smoke", "--requests", "2",
                    "--prompt-len", "6", "--gen", "2", "--device", "cpu"])
    assert "served 2 requests" in capsys.readouterr().out
    monkeypatch.chdir(tmp_path)
    out = train_cli.main(["--arch", "qwen2-vl-7b", "--smoke", "--steps", "1",
                          "--chunk", "1", "--batch", "1", "--seq", "8",
                          "--device", "cpu"])
    assert np.isfinite(out["history"][0]["loss"])
    for cli, extra in ((serve_cli, ["--requests", "1"]),
                       (train_cli, ["--steps", "1"])):
        with pytest.raises(ValueError, match="audio_embed"):
            cli.main(["--arch", "whisper-small", "--smoke", "--device",
                      "cpu"] + extra)
