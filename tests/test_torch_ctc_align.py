"""The port's CTC forced alignment (scannertools_tpu_torch/ops/ctc_align.py)
held to the JAX package's (scannertools_tpu/ops/ctc_align.py).

Every case of tests/test_ctc_align.py runs on the port, on the CPU, where
``ctc_viterbi`` is its plain version ``viterbi_plain``. The port's path is
then held to the jitted JAX ``ctc_forced_align``, states equal and scores
bit-equal (``==`` on float32), on seeded emissions, all-zero emissions
(every move ties), repeated tokens (the skip barred), ``T == need`` (the
tightest lattice) and a batch of windows of mixed T and S in one call; and
``TranscriptAligner.align_words_ctc`` (one batched call) gives records
equal to the JAX package's (one jitted program a window). Inputs are made
from a seed with numpy. The kernel's own cases are in
tests/test_torch_kernels_cuda.py, on the card.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from scannertools_tpu.ops import ctc_align as J
from scannertools_tpu.ops.legacy_extras import \
    TranscriptAligner as JTranscriptAligner
from scannertools_tpu_torch.ops import ctc_align as P
from scannertools_tpu_torch.ops.legacy_extras import TranscriptAligner
from scannertools_tpu_torch.tools.timing import planted_emissions
from test_ctc_align import (FRAME_S, _emissions, _speak,
                            _tone_ctc_emissions)

CPU = "cpu"


@dataclasses.dataclass
class Cap:
    line: str
    start: float
    end: float


def _vocab_v():
    vocab = P.char_vocab()
    return vocab, max(vocab.values()) + 1


def need(tokens):
    return P.lattice(np.asarray(tokens), 0)[2]


def assert_same_path(lp, tokens, blank=0):
    got_idx, got_score = P.ctc_forced_align(lp, tokens, blank=blank,
                                            device=CPU)
    want_idx, want_score = J.ctc_forced_align(lp, tokens, blank=blank)
    assert got_idx.dtype == np.int32
    np.testing.assert_array_equal(got_idx, want_idx)
    assert np.float32(got_score) == np.float32(want_score), (got_score,
                                                             want_score)


# ------------------------------------------- the JAX package's cases


def test_forced_align_recovers_exact_path():
    vocab, V = _vocab_v()
    h, i = vocab["h"], vocab["i"]
    lp = _emissions([0, h, h, i, 0], V)
    tok_idx, score = P.ctc_forced_align(lp, [h, i], device=CPU)
    assert tok_idx.tolist() == [-1, 0, 0, 1, -1]
    assert score > -1.0


def test_repeated_token_requires_blank():
    vocab, V = _vocab_v()
    a = vocab["a"]
    tok_idx, _ = P.ctc_forced_align(_emissions([a, a, a], V), [a, a],
                                    device=CPU)
    assert tok_idx.tolist() == [0, -1, 1]


def test_too_few_frames_raises():
    vocab, V = _vocab_v()
    a = vocab["a"]
    with pytest.raises(ValueError):
        P.ctc_forced_align(_emissions([a, a], V), [a, a], device=CPU)


def test_no_tokens_is_all_blank():
    lp = _emissions([0, 3, 0], 5)
    got = P.ctc_forced_align(lp, [], device=CPU)
    want = J.ctc_forced_align(lp, [])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_word_alignment_and_scores():
    vocab, V = _vocab_v()
    text = "hello world"
    tokens, words, spans = P.encode_transcript(text, vocab)
    assert (tokens, words, spans) == J.encode_transcript(text, vocab)
    gt, prev = [], None
    for t in tokens:
        if prev == t:
            gt.append(0)
        gt.extend([t, t])
        prev = t
    gt = [0] + gt + [0]
    lp = _emissions(gt, V)
    out = P.align_transcript_ctc(lp, text, frame_s=0.05, vocab=vocab,
                                 device=CPU)
    assert [w.word for w in out] == ["hello", "world"]
    hello, world = out
    assert hello.start == pytest.approx(0.05)
    assert hello.end == pytest.approx(0.05 * 12)
    assert world.end <= 0.05 * len(gt)
    assert hello.start < hello.end < world.start < world.end
    assert all(w.success() for w in out)
    want = J.align_transcript_ctc(lp, text, frame_s=0.05, vocab=vocab)
    assert [dataclasses.astuple(w) for w in out] == \
        [dataclasses.astuple(w) for w in want]


def test_missing_word_scores_low():
    vocab, V = _vocab_v()
    tokens, _, _ = P.encode_transcript("hi", vocab)
    gt = [0] + [t for t in tokens for _ in (0, 1)] + [0] * 8
    lp = _emissions(gt, V)
    out = P.align_transcript_ctc(lp, "hi zebra", frame_s=0.05, vocab=vocab,
                                 device=CPU)
    assert out[0].word == "hi" and out[0].success()
    assert out[1].word == "zebra" and not out[1].success()


def test_transcript_aligner_ctc_windows():
    vocab, V = _vocab_v()
    h, i, g, o = vocab["h"], vocab["i"], vocab["g"], vocab["o"]
    fs = 0.1
    gt = [0] * 50
    gt[10:14] = [h, h, i, i]
    gt[30:34] = [g, g, o, o]
    lp = _emissions(gt, V)
    caps = [Cap("hi", 0.9, 1.5), Cap("go", 2.9, 3.5)]
    out = TranscriptAligner().align_words_ctc(caps, lp, fs, vocab=vocab,
                                              device=CPU)
    assert [w.word for w in out] == ["hi", "go"]
    assert out[0].start == pytest.approx(1.0, abs=fs)
    assert out[0].end == pytest.approx(1.4, abs=fs)
    assert out[1].start == pytest.approx(3.0, abs=fs)
    assert out[1].end == pytest.approx(3.4, abs=fs)
    assert all(isinstance(w, P.AlignedWord) and w.success() for w in out)


def test_unencodable_chars_dropped_not_keyerror():
    vocab = {c: i + 1 for i, c in enumerate("abcdefghijklmnopqrstuvwxyz")}
    tokens, words, spans = P.encode_transcript("don't stop ''", vocab)
    assert words == ["dont", "stop"]
    assert len(tokens) == len("dontstop")
    gt = [0] + [t for t in tokens for _ in (0, 1)] + [0]
    lp = _emissions(gt, 27)
    out = P.align_transcript_ctc(lp, "don't stop", frame_s=0.05,
                                 vocab=vocab, device=CPU)
    assert [w.word for w in out] == ["dont", "stop"]
    assert all(w.success() for w in out)


@pytest.mark.parametrize("spoken,success", [("hello world again", True),
                                            ("quiet system jumps", False)])
def test_acoustic_end_to_end(spoken, success):
    """The tone-model drill of tests/test_ctc_align.py: word times match
    the synthesis schedule where the audio says the caption, and every
    word scores low where it says something else; records equal JAX's."""
    vocab, _ = _vocab_v()
    samples, gt = _speak(spoken, vocab, np.random.default_rng(
        0 if success else 1))
    lp = _tone_ctc_emissions(samples, vocab)
    caps = [Cap("hello world again", gt[0][1] - 0.1, gt[-1][2] + 0.1)]
    out = TranscriptAligner().align_words_ctc(caps, lp, FRAME_S,
                                              vocab=vocab, device=CPU)
    assert [w.word for w in out] == ["hello", "world", "again"]
    if success:
        for got, (word, s, e) in zip(out, gt):
            assert got.start == pytest.approx(s, abs=3 * FRAME_S), word
            assert got.end == pytest.approx(e, abs=3 * FRAME_S), word
            assert got.success(), (word, got.score)
    else:
        assert not any(w.success() for w in out)
    want = JTranscriptAligner().align_words_ctc(caps, lp, FRAME_S,
                                                vocab=vocab)
    assert [dataclasses.astuple(w) for w in out] == \
        [dataclasses.astuple(w) for w in want]


# ------------------------------------------- parity with the jitted JAX


@pytest.mark.parametrize("seed,n_tok,extra", [(0, 5, 10), (1, 12, 3),
                                              (2, 30, 40), (3, 1, 6)])
def test_seeded_emissions_match_jax(seed, n_tok, extra):
    rng = np.random.default_rng(seed)
    vocab, V = _vocab_v()
    tokens = rng.integers(1, V, n_tok).tolist()
    lp = planted_emissions(rng, tokens, need(tokens) + extra, V)
    assert_same_path(lp, tokens)
    # unplanted noise: the path is the DP's alone
    noise = rng.normal(0, 2, lp.shape).astype(np.float32)
    assert_same_path(noise - np.log(np.exp(noise).sum(1, keepdims=True)),
                     tokens)


@pytest.mark.parametrize("n_tok,t", [(1, 1), (1, 4), (3, 3), (6, 20)])
def test_all_zero_emissions_tie_like_jax(n_tok, t):
    """Every move ties at every cell: the path is the tie order's alone."""
    vocab, V = _vocab_v()
    tokens = list(range(2, 2 + n_tok))
    assert_same_path(np.zeros((t, V), np.float32), tokens)


@pytest.mark.parametrize("tokens", [[5, 5], [5, 5, 5, 7, 7], [9, 9, 9, 9]])
def test_repeated_tokens_match_jax(tokens):
    rng = np.random.default_rng(len(tokens))
    V = 32
    for t in (need(tokens), need(tokens) + 5):
        assert_same_path(planted_emissions(rng, tokens, t, V), tokens)
        assert_same_path(np.zeros((t, V), np.float32), tokens)


@pytest.mark.parametrize("seed", [4, 5])
def test_t_equals_need_matches_jax(seed):
    rng = np.random.default_rng(seed)
    V = 32
    tokens = rng.integers(1, 4, 15).tolist()  # small alphabet: repeats
    lp = planted_emissions(rng, tokens, need(tokens), V)
    assert_same_path(lp, tokens)
    idx, _ = P.ctc_forced_align(lp, tokens, device=CPU)
    assert sorted(set(idx.tolist()) - {-1}) == list(range(len(tokens)))


def test_blank_elsewhere_matches_jax():
    rng = np.random.default_rng(6)
    V = 32
    tokens = [0, 3, 3, 7]  # token 0 is a label when the blank is 31
    assert_same_path(planted_emissions(rng, tokens, 14, V, blank=31), tokens,
                     blank=31)


def test_mixed_batch_equals_windows():
    """Windows of different T and S in one ctc_viterbi call: each window's
    path and score equal its own JAX program's; padded frames and states
    do not leak into a window's final state or its path."""
    rng = np.random.default_rng(7)
    V = 32
    windows = []
    for t, n in [(40, 5), (9, 4), (60, 25), (25, 1), (30, 12)]:
        tokens = rng.integers(1, V, n).tolist()
        windows.append((planted_emissions(rng, tokens, max(t, need(tokens)), V),
                        tokens))
    got = P.ctc_forced_align_batch(windows, device=CPU)
    for (lp, tokens), (idx, score) in zip(windows, got):
        want_idx, want_score = J.ctc_forced_align(lp, tokens)
        np.testing.assert_array_equal(idx, want_idx)
        assert np.float32(score) == np.float32(want_score)
    # padding that would win if it leaked: hot padded frames
    lp, t_len, labels, skip, s_len = (torch.from_numpy(x)
                                      for x in P.pack_windows(windows))
    for k, (w, _) in enumerate(windows):
        lp[k, w.shape[0]:] = 5.0
    states, scores = P.ctc_viterbi(lp, t_len, labels, skip, s_len)
    for k, ((w, _), (idx, score)) in enumerate(zip(windows, got)):
        st = states[k].numpy()
        t = w.shape[0]
        assert (st[t:] == -1).all()
        np.testing.assert_array_equal(
            np.where(st[:t] % 2 == 1, (st[:t] - 1) // 2, -1), idx)
        assert scores[k].item() == np.float32(score)


def test_skip_flags_below_state_2_read_no_state_like_jax():
    """allow_skip set on states 0 and 1, which have no state s - 2: the
    plain batch, like the JAX program, reads no state there, so the flags
    change nothing. (The kernel's case is in test_torch_kernels_cuda.)"""
    rng = np.random.default_rng(9)
    V = 32
    windows = [(planted_emissions(rng, tok, t, V), tok)
               for tok, t in [([4, 9, 2], 12), ([7], 3), ([3, 3, 8], 10)]]
    windows.append((np.zeros((6, V), np.float32), [5, 6]))
    lp, t_len, labels, skip, s_len = (torch.from_numpy(x)
                                      for x in P.pack_windows(windows))
    want = P.ctc_viterbi_plain(lp, t_len, labels, skip, s_len)
    skip[:, :2] = True
    got = P.ctc_viterbi_plain(lp, t_len, labels, skip, s_len)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for k, (w, _) in enumerate(windows):
        t, s = w.shape[0], int(s_len[k])
        j_states, j_score = J._viterbi_fn(t, s, V)(
            w, labels[k, :s].numpy(), skip[k, :s].numpy())
        np.testing.assert_array_equal(got[0][k, :t].numpy(),
                                      np.asarray(j_states))
        assert got[1][k].item() == np.float32(j_score)


def test_pack_windows_checks_labels():
    with pytest.raises(ValueError):
        P.pack_windows([(np.zeros((5, 4), np.float32), [1, 4])])


def test_align_words_ctc_batched_equals_jax():
    """Caption windows of a track through the batched call: records equal
    to the JAX package's per-window programs, field for field."""
    rng = np.random.default_rng(8)
    vocab, V = _vocab_v()
    words = ["alpha", "bee", "see", "deed", "echo", "fox", "golf", "all"]
    fs, n_fr = 0.02, 1500
    caps, gt = [], np.zeros(n_fr, np.int64)
    t = 20
    for k in range(9):
        line = " ".join(rng.choice(words, rng.integers(1, 4)))
        tokens, _, _ = P.encode_transcript(line, vocab)
        start = t
        for tok in tokens:
            gt[t:t + 3] = tok
            t += 4
        caps.append(Cap(line, start * fs, t * fs))
        t += 30
    caps.append(Cap("!!", 0.5, 0.7))  # no encodable word: no records
    logits = rng.normal(0, 1, (n_fr, V)).astype(np.float32)
    logits[np.arange(n_fr), gt] += 4.0
    z = logits - logits.max(1, keepdims=True)
    lp = (z - np.log(np.exp(z).sum(1, keepdims=True))).astype(np.float32)
    got = TranscriptAligner().align_words_ctc(caps, lp, fs, vocab=vocab,
                                              margin_s=0.3, device=CPU)
    want = JTranscriptAligner().align_words_ctc(caps, lp, fs, vocab=vocab,
                                                margin_s=0.3)
    assert len(got) > 9
    assert [dataclasses.astuple(w) for w in got] == \
        [dataclasses.astuple(w) for w in want]


def test_max_states_matches_kernel_source():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scannertools_tpu_torch", "kernels",
        "csrc", "ctc.cu")
    src = open(path).read()
    per = int(re.search(r"kPerThread = (\d+);", src).group(1))
    threads = int(re.search(r"kMaxThreads = (\d+);", src).group(1))
    assert P.MAX_STATES == per * threads
    # the warp path: 32 lanes of at most kMaxK states each
    lanes = int(re.search(r"kLanes = (\d+);", src).group(1))
    per_lane = int(re.search(r"kMaxK = (\d+);", src).group(1))
    assert "kWarpMaxStates = kLanes * kMaxK;" in src
    assert P.WARP_MAX_STATES == lanes * per_lane == 256
    assert P.viterbi_geometry(1, 10, P.WARP_MAX_STATES, 32)["path"] == "warp"
    assert P.viterbi_geometry(1, 10, P.WARP_MAX_STATES + 1,
                              32)["path"] == "block"
    assert P.viterbi_geometry(1, 10, P.MAX_STATES, 32)["path"] == "block"
