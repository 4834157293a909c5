"""PyTorch port, Word2Vec (``models/word2vec.py``) against the JAX
package's on the CPU.

Reference trains run on a one-row-shard mesh. Held here:
- BITWISE: the vocabulary, counts, corpus remap, sentence ids and the
  ``unigram^0.75`` table, the ``Win`` init, the batch and step counts
  and the learning rates (all as the reference hands them to its
  compiled train, caught by a spy); one epoch's draws and the pairs'
  ``valid`` mask; the table's last entry is 1.0f, so ``searchsorted``
  never passes the vocabulary;
- a one-epoch and a two-epoch train on a small Zipf corpus: embeddings
  within 1e-5 of the largest |w| (measured: bitwise on the CPU);
- ``find_synonyms`` in the reference's order wherever neighbouring
  similarities differ by more than that tolerance; ``transform`` NONE
  and AVERAGE, ``to_frame``, and the errors.
"""

import jax
import numpy as np
import pytest
import torch

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu.models import word2vec as JW
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
from h2o_kubernetes_tpu_torch import Frame, Word2Vec
from h2o_kubernetes_tpu_torch.models import word2vec as TW
from h2o_kubernetes_tpu_torch.runtime import prng
from tools.datasets import text8_like_tokens, zipf_probs

_MESH1 = make_mesh(n_rows=1)
_W_REL = 1e-5
_KW = dict(vec_size=16, min_word_freq=2, seed=1, window_size=3,
           negative_samples=4)


@pytest.fixture(scope="module")
def trained():
    toks = text8_like_tokens(6000, vocab_size=300, seed=5)
    toks[7] = "rare_only_once"                      # under min_word_freq
    tf = Frame.from_arrays({"words": toks}, device="cpu")
    out, seen = {}, {}
    real = JW._w2v_train

    def spy(params, corpus_dev, sent_dev, ns_cdf, key, lrs, **kw):
        seen.setdefault("args", (np.asarray(params[0]),
                                 np.asarray(corpus_dev),
                                 np.asarray(sent_dev), np.asarray(ns_cdf),
                                 np.asarray(lrs), kw))
        return real(params, corpus_dev, sent_dev, ns_cdf, key, lrs, **kw)

    with use_mesh(_MESH1):
        jf = h2o.Frame.from_arrays({"words": toks})
        JW._w2v_train = spy
        try:
            out[1] = (JW.Word2Vec(epochs=1, **_KW).train(jf),
                      Word2Vec(epochs=1, **_KW).train(tf))
        finally:
            JW._w2v_train = real
        out[2] = (JW.Word2Vec(epochs=2, **_KW).train(jf),
                  Word2Vec(epochs=2, **_KW).train(tf))
    return out, seen["args"], toks, tf, jf


def test_vocab_init_and_schedule_bitwise(trained):
    (jm, tm), (win, corp, sent, cdf, lrs, kw), toks, tf = trained[0][1], \
        trained[1], trained[2], trained[3]
    col = tf.vec("words")
    vocab, counts, corpus, sent_id, ns_cdf = TW.build_vocab(
        col.to_numpy(), list(col.domain), _KW["min_word_freq"])
    assert vocab == jm.vocab == tm.vocab and "rare_only_once" not in vocab
    np.testing.assert_array_equal(counts, jm.counts)
    np.testing.assert_array_equal(corpus, corp)
    np.testing.assert_array_equal(sent_id, sent)
    np.testing.assert_array_equal(ns_cdf.view(np.int32), cdf.view(np.int32))
    assert ns_cdf[-1] == np.float32(1.0)
    D = _KW["vec_size"]
    _, k1, _ = prng.split(prng.key(_KW["seed"]), 3)
    got = prng.uniform(k1, (len(vocab), D), -0.5 / D, 0.5 / D).numpy()
    np.testing.assert_array_equal(got.view(np.int32), win.view(np.int32))
    L = len(corpus)
    assert kw["batch"] == min(8192, max(512, L))
    assert kw["steps"] == max(1, L * 2 * _KW["window_size"] // kw["batch"])
    np.testing.assert_array_equal(lrs, np.float32([0.025]))


@pytest.mark.parametrize("V", [300, 5_000, 71_290])
def test_table_ends_at_one(V):
    """The float32 table's last entry is exactly 1.0 for Zipf counts of
    the suite's and text8's vocabulary sizes, so every uniform draw
    (< 1) lands inside the vocabulary."""
    counts = np.maximum(1, np.round(zipf_probs(V) * 17_005_207))
    pw = counts.astype(np.float64) ** 0.75
    assert np.cumsum(pw / pw.sum()).astype(np.float32)[-1] == 1.0


@pytest.mark.parametrize("chunk", [3, 100])
def test_epoch_draws_and_pairs_bitwise(chunk):
    """One epoch's draws as the reference's step makes them (split(k,
    3), two randints, bernoulli(0.5), fold_in(kn, 1), uniform), and the
    pairs' words and ``valid`` mask as its step forms them."""
    steps, batch, window, k_neg = 11, 512, 3, 4
    rng = np.random.default_rng(2)
    L = 2000
    corp = rng.integers(-1, 50, L).astype(np.int32)
    sent = np.cumsum(rng.random(L) < 0.05).astype(np.int32)
    jke = jax.random.split(jax.random.key(4), 2)[1]
    keys = jax.random.split(jax.random.fold_in(jke, 0), steps)
    ke = prng.split(prng.key(4), 2)[1]
    got = list(TW.epoch_draws(ke, steps, batch, L, window, k_neg, chunk))
    ci, off, sign, u = (torch.cat([g[i] for g in got]) for i in range(4))
    tcorp, tsent = torch.as_tensor(corp).long(), torch.as_tensor(sent)
    for s in range(steps):
        kc, ko, kn = jax.random.split(keys[s], 3)
        jci = jax.random.randint(kc, (batch,), 0, L)
        joff = jax.random.randint(ko, (batch,), 1, window + 1)
        jsign = jax.random.bernoulli(kn, 0.5, (batch,))
        ju = jax.random.uniform(jax.random.fold_in(kn, 1), (batch, k_neg))
        np.testing.assert_array_equal(ci[s].numpy(), np.asarray(jci))
        np.testing.assert_array_equal(off[s].numpy(), np.asarray(joff))
        np.testing.assert_array_equal(sign[s].numpy(), np.asarray(jsign))
        np.testing.assert_array_equal(u[s].numpy().view(np.int32),
                                      np.asarray(ju).view(np.int32))
        jci, joff, jsign = (np.asarray(a) for a in (jci, joff, jsign))
        oi = np.clip(jci + np.where(jsign, joff, -joff), 0, L - 1)
        want_valid = (corp[jci] >= 0) & (corp[oi] >= 0) & \
            (sent[jci] == sent[oi]) & (jci != oi)
        c, o, valid = TW.pairs(tcorp, tsent, ci[s], off[s], sign[s], L)
        np.testing.assert_array_equal(valid.numpy(),
                                      want_valid.astype(np.float32))
        np.testing.assert_array_equal(c.numpy(), np.maximum(corp[jci], 0))
        np.testing.assert_array_equal(o.numpy(), np.maximum(corp[oi], 0))


@pytest.mark.parametrize("epochs", [1, 2])
def test_train_matches_reference(trained, epochs):
    jm, tm = trained[0][epochs]
    assert tm.W.dtype == np.float32 and tm.W.shape == jm.W.shape
    assert np.abs(tm.W - jm.W).max() <= _W_REL * np.abs(jm.W).max()
    np.testing.assert_array_equal(tm.counts, jm.counts)


def test_find_synonyms_order(trained):
    """Equal in order wherever neighbouring similarities differ by more
    than the tolerance (a near-tie may swap)."""
    jm, tm = trained[0][1]
    for word in tm.vocab[:10] + tm.vocab[-5:]:
        want = list(jm.find_synonyms(word, 8).items())
        got = list(tm.find_synonyms(word, 8).items())
        assert [w for w, _ in got] != [] and len(got) == len(want)
        for i, ((wg, sg), (ww, sw)) in enumerate(zip(got, want)):
            assert abs(sg - sw) <= 1e-5
            near = [abs(sw - want[j][1]) <= 2e-5 for j in (i - 1, i + 1)
                    if 0 <= j < len(want)]
            assert wg == ww or any(near), (word, i)
    assert tm.find_synonyms("not_a_word") == {}


def test_transform_and_to_frame(trained):
    (jm, tm), toks, tf, jf = trained[0][1], trained[2], trained[3], \
        trained[4]
    carried = TW.Word2VecModel(tm.params, list(jm.vocab), jm.counts, jm.W)
    for how in ("NONE", "AVERAGE"):
        with use_mesh(_MESH1):
            want = jm.transform(jf, how)
        got = carried.transform(tf, how)
        assert got.shape == want.shape
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got[~np.isnan(got)],
                                      want[~np.isnan(want)])
    fr = tm.to_frame(device="cpu")
    assert fr.names == ["Word"] + [f"V{d + 1}" for d in range(16)]
    assert fr.nrows == len(tm.vocab) and fr.vec("Word").is_enum()
    np.testing.assert_array_equal(fr.vec("V3").to_numpy(), tm.W[:, 2])


def test_errors():
    fr = Frame.from_arrays({"x": np.arange(5.0)}, device="cpu")
    with pytest.raises(ValueError, match="single string/enum column"):
        Word2Vec().train(fr)
    fr = Frame.from_arrays({"w": np.array(["a", "b", None, "c"],
                                          dtype=object)}, device="cpu")
    with pytest.raises(ValueError, match="no words meet min_word_freq"):
        Word2Vec(min_word_freq=2).train(fr)
