"""Word2Vec — skip-gram embeddings with negative sampling on one device.

``Word2Vec(...).train(training_frame)`` is the JAX package's entry
point: a Frame of ONE string/enum column of words, sentences separated
by NA rows; it trains where the frame lives (the card by default). The
vocabulary (words of at least ``min_word_freq`` occurrences, by
frequency), the corpus remap, the sentence ids and the ``unigram^0.75``
cumulative table are host numpy, as the reference's.

Each step draws ``batch`` (center, context) pairs — a random position,
an offset in ``[1, window]`` with a random sign — keeps the pairs inside
one sentence with both words in the vocabulary, draws
``negative_samples`` negatives per pair by inverse CDF, and descends the
negative-sampling loss. The gradient is written out by hand (two
embedding gathers, the pair dots, their sigmoids) and scattered into
zeroed ``[V, D]`` buffers (``index_add_``), the contexts' and the
negatives' each on its own and then summed, as ``jax.grad`` transposes
the reference's gathers; each table then takes one dense update
``W - lr·G``.

The draws are the JAX package's, through the threefry twin: per epoch
one key of ``split(key, epochs)``, the row shard's ``fold_in`` (shard
0), one key per step; per step ``split(k, 3)`` into the centers'
``randint``, the offsets' ``randint``, the signs' ``bernoulli(0.5)``
and, through ``fold_in(kn, 1)``, the negatives' ``uniform``. They are
made before the steps, in batched twin calls over chunks of step keys.
The reference averages the shards' tables after each epoch; in one
process that average is the identity, and on a row group Word2Vec
raises (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..runtime import prng
from ..runtime.mesh import single_process_only

__all__ = ["Word2Vec", "Word2VecModel", "Word2VecParams", "build_vocab",
           "epoch_draws", "pairs"]

# the most elements a chunk of an epoch's draws holds at once: the
# twin's int64 words stay near 256 MB
_DRAW_ELEMS = 1 << 25


@dataclass
class Word2VecParams:
    vec_size: int = 100
    window_size: int = 5
    min_word_freq: int = 5
    negative_samples: int = 5
    epochs: int = 5
    init_learning_rate: float = 0.025
    batch_per_shard: int = 8192
    seed: int = 0


def build_vocab(codes: np.ndarray, domain: list[str], min_word_freq: int):
    """(vocab, counts float64, corpus int32 (-1 outside the vocabulary
    and at NA rows), sentence ids int32, the ``unigram^0.75`` cumulative
    table float32) from a word column's codes: the reference's host
    numpy, line for line."""
    freq = np.bincount(codes[codes >= 0], minlength=len(domain))
    keep = np.where(freq >= min_word_freq)[0]
    keep = keep[np.argsort(-freq[keep])]
    vocab = [domain[i] for i in keep]
    V = len(vocab)
    if V == 0:
        raise ValueError("no words meet min_word_freq")
    remap = np.full(len(domain) + 1, -1, dtype=np.int32)
    remap[keep] = np.arange(V, dtype=np.int32)
    corpus = remap[np.where(codes < 0, len(domain), codes)]
    sent_id = np.cumsum(codes < 0).astype(np.int32)
    counts = freq[keep].astype(np.float64)
    pw = counts ** 0.75
    # the last entry rounds to 1.0f (the float64 sum is within a few
    # ulps of 1), above every uniform draw: searchsorted stays < V
    ns_cdf = np.cumsum(pw / pw.sum()).astype(np.float32)
    return vocab, counts, corpus, sent_id, ns_cdf


def epoch_draws(ke: torch.Tensor, steps: int, batch: int, L: int,
                window: int, k_neg: int, chunk: int):
    """The draws of one epoch, ``chunk`` steps at a time: yields
    (positions [c, batch], offsets [c, batch] in [1, window], signs
    [c, batch] bool, negatives' uniforms [c, batch, k_neg] float32) for
    each chunk of the epoch's ``steps`` step keys (``fold_in(ke, 0)``
    split ``steps`` ways, each split in three)."""
    ks = prng.split(prng.fold_in(ke, 0), steps)
    for s0 in range(0, steps, chunk):
        kk = prng.split(ks[s0:s0 + chunk], 3)         # [c, 3, 2]
        ci = prng.randint(kk[:, 0], (batch,), 0, L)
        off = prng.randint(kk[:, 1], (batch,), 1, window + 1)
        sign = prng.bernoulli(kk[:, 2], 0.5, (batch,))
        u = prng.uniform(prng.fold_in(kk[:, 2], 1), (batch, k_neg))
        yield ci, off, sign, u


def pairs(corp, sent, ci, off, sign, L: int):
    """(center words, context words, valid float mask) of one step's
    draws: the context ``off`` positions before or after the center,
    clipped to the corpus; a pair is valid when both words are in the
    vocabulary, in one sentence, at two positions. Words outside the
    vocabulary read row 0 (their pairs are masked)."""
    oi = torch.clamp(ci + torch.where(sign, off, -off), 0, L - 1)
    centers, contexts = corp[ci], corp[oi]
    valid = ((centers >= 0) & (contexts >= 0) & (sent[ci] == sent[oi])
             & (ci != oi)).float()
    return torch.clamp_min(centers, 0), torch.clamp_min(contexts, 0), valid


def _sgd_step(Win, Wout, corp, sent, cdf, ci, off, sign, u, lr: float,
              L: int, G: tuple) -> None:
    """One step of the reference's ``_w2v_local_epoch`` at one draw:
    the pairs, their mask, the negatives, the hand-written gradient of
    the mean negative-sampling loss over valid pairs, scattered into the
    zeroed buffers ``G`` (inputs, contexts, negatives), then ``W - lr·G``
    on both tables."""
    D = Win.shape[1]
    c, o, valid = pairs(corp, sent, ci, off, sign, L)
    negs = torch.searchsorted(cdf, u)                  # [B, k]
    v, uo, un = Win[c], Wout[o], Wout[negs]           # [B,D] [B,D] [B,k,D]
    s = torch.sum(v * uo, dim=1)
    t = torch.einsum("bd,bkd->bk", v, un)
    coef = valid / (torch.sum(valid) + 1e-9)
    # d(loss)/ds = -coef·sigmoid(-s), d(loss)/dt = coef·sigmoid(t)
    gs = -coef * torch.sigmoid(-s)
    gt = coef[:, None] * torch.sigmoid(t)
    gv = gs[:, None] * uo + torch.einsum("bk,bkd->bd", gt, un)
    g_in, g_ctx, g_neg = G
    for g in G:
        g.zero_()
    g_in.index_add_(0, c, gv)
    g_ctx.index_add_(0, o, gs[:, None] * v)
    g_neg.index_add_(0, negs.reshape(-1),
                     (gt[..., None] * v[:, None, :]).reshape(-1, D))
    Win.sub_(g_in, alpha=lr)
    Wout.sub_(g_ctx + g_neg, alpha=lr)


class Word2VecModel:
    """The vocabulary, its counts and the input embeddings ``W`` [V, D]
    (float32 numpy)."""

    algo = "word2vec"

    def __init__(self, params: Word2VecParams, vocab: list[str],
                 counts: np.ndarray, W: np.ndarray):
        self.params = params
        self.vocab = vocab
        self.word_index = {w: i for i, w in enumerate(vocab)}
        self.counts = counts
        self.W = W

    def find_synonyms(self, word: str, count: int = 10) -> dict[str, float]:
        """The ``count`` words of highest cosine similarity to ``word``
        (itself excluded), highest first; {} for an unknown word."""
        i = self.word_index.get(word)
        if i is None:
            return {}
        Wn = self.W / (np.linalg.norm(self.W, axis=1, keepdims=True) + 1e-9)
        sims = Wn @ Wn[i]
        order = np.argsort(-sims)
        out = {}
        for j in order:
            if j == i:
                continue
            out[self.vocab[j]] = float(sims[j])
            if len(out) >= count:
                break
        return out

    def to_frame(self, device=None):
        """The embeddings as a Frame: ``Word`` and ``V1..VD`` (on
        ``device``, None = the CUDA card)."""
        from ..frame import Frame

        cols = {"Word": np.array(self.vocab)}
        for d in range(self.W.shape[1]):
            cols[f"V{d + 1}"] = self.W[:, d]
        return Frame.from_arrays(cols, device=device)

    def transform(self, words_frame,
                  aggregate_method: str = "NONE") -> np.ndarray:
        """Words -> vectors (NaN rows for NA and unknown words); AVERAGE
        pools per NA-separated sentence."""
        col = words_frame.vec(words_frame.names[0])
        codes = col.to_numpy()
        dom = col.domain or []
        remap = np.array([self.word_index.get(w, -1) for w in dom] + [-1],
                         dtype=np.int64)
        idx = remap[np.where(codes < 0, len(dom), codes)]
        vecs = np.where((idx >= 0)[:, None],
                        self.W[np.maximum(idx, 0)], np.nan)
        if aggregate_method.upper() == "NONE":
            return vecs
        sent_id = np.cumsum(codes < 0)
        out = []
        for s in np.unique(sent_id[codes >= 0]):
            rows = vecs[(sent_id == s) & (codes >= 0) & (idx >= 0)]
            out.append(rows.mean(axis=0) if len(rows) else
                       np.full(self.W.shape[1], np.nan))
        return np.stack(out) if out else np.empty((0, self.W.shape[1]))

    @property
    def _artifact_meta(self) -> dict:
        """The MOJO-v2 meta of this model (the JAX package writes the
        tabular fields' defaults for word2vec)."""
        return {"algo": "word2vec", "feature_names": [],
                "feature_domains": {}, "nclasses": 1,
                "response_domain": None, "distribution": None,
                "offset_column": None, "vocab": list(self.vocab)}

    @property
    def _artifact_arrays(self) -> dict:
        return {"embeddings": np.asarray(self.W, dtype=np.float32)}


class Word2Vec:
    """H2OWord2vecEstimator analog."""

    def __init__(self, **kw):
        self.params = Word2VecParams(**kw)

    def train(self, training_frame) -> Word2VecModel:
        """Train on ``training_frame``'s device; returns the model (its
        embeddings on the host)."""
        single_process_only("Word2Vec")
        p = self.params
        col = training_frame.vec(training_frame.names[0])
        if not col.is_enum():
            raise ValueError("word2vec needs a single string/enum column")
        vocab, counts, corpus, sent_id, cdf = build_vocab(
            col.to_numpy(), list(col.domain), p.min_word_freq)
        dev = training_frame.device
        V, D, W_len = len(vocab), p.vec_size, p.window_size
        L = len(corpus)
        corp = torch.as_tensor(corpus.astype(np.int64), device=dev)
        sent = torch.as_tensor(sent_id, device=dev)
        cdf_dev = torch.as_tensor(cdf, device=dev)

        key, k1, _ = prng.split(prng.key(p.seed, device=dev), 3)
        Win = prng.uniform(k1, (V, D), -0.5 / D, 0.5 / D)
        Wout = torch.zeros((V, D), dtype=torch.float32, device=dev)
        # batch capped by the corpus: a big batch on a small corpus
        # collapses an epoch into one update (the reference's rule, one
        # shard)
        batch = int(min(p.batch_per_shard, max(512, L)))
        steps = max(1, L * 2 * W_len // batch)
        lrs = np.asarray([p.init_learning_rate * max(1.0 - e / p.epochs,
                                                     1e-3)
                          for e in range(p.epochs)], dtype=np.float32)
        G = tuple(torch.empty_like(Win) for _ in range(3))
        chunk = max(1, _DRAW_ELEMS // (batch * p.negative_samples))
        for ke, lr in zip(prng.split(key, p.epochs), lrs):
            for ci, off, sign, u in epoch_draws(
                    ke, steps, batch, L, W_len, p.negative_samples, chunk):
                for s in range(ci.shape[0]):
                    _sgd_step(Win, Wout, corp, sent, cdf_dev, ci[s],
                              off[s], sign[s], u[s], float(lr), L, G)
            # one row shard: the reference's average of the shards'
            # tables (psum / n) is the identity here
        return Word2VecModel(p, vocab, counts, Win.cpu().numpy())
