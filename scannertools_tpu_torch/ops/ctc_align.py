"""CTC forced alignment: ASR-based per-word transcript timing.

Reference parity: old/transcript_alignment.py:206-342 drives the external
`gentle` (Kaldi) forced-alignment server to produce word-level
(start, end, case) records per sliding caption window. This module is the
same capability, self-contained: given CTC emission log-probs from any
character-level acoustic model (e.g. a Wav2Vec2ForCTC checkpoint via
`transformers`, or logits computed elsewhere), a Viterbi dynamic program
over the standard CTC lattice recovers the exact frame-level path for the
transcript and hence per-word (start, end) plus a per-word acoustic score
(gentle's success / not-found-in-audio analog).

The JAX package's ops/ctc_align.py (scannertools_tpu) runs the DP as one
jitted ``lax.scan`` per window shape (``_viterbi_fn``, :79-113). Here it
is the hand-written CUDA kernel ``ctc_viterbi`` (kernels/csrc/ctc.cu),
every window of a call in one launch, so a track's caption windows cost
one launch where a plain torch loop costs about six a frame. The launch
takes one of two paths, which ``viterbi_geometry`` picks:

- the warp path, for at most WARP_MAX_STATES = 256 states (a caption of
  up to 127 characters) and a Tmax whose packed moves fit a block's
  shared memory (about 3,500 frames at V = 32): a warp a window, its
  alpha in registers, its moves in shared memory at 2 bits a state, no
  device-memory scratch;
- the block path, for up to MAX_STATES = 4096 states and any Tmax: a
  block a window, alpha in shared memory, int8 back-pointers in a
  [B, Tmax - 1, Smax] device-memory scratch.

``viterbi_plain`` beside it is that loop, step for step the JAX
program's; the wrapper runs it for CPU tensors, and both paths are held
to it bit for bit on the card.

The lattice: state 2i+1 emits token i, even states emit blank. A valid
path may move s->s (stay), s-1->s (advance), and s-2->s (skip a blank)
only when s is a token state whose token differs from the previous token
state's (CTC's repeated-label rule). On equal values the first move wins,
in the order stay, advance, skip (``jnp.argmax``'s first maximum), and the
path ends on the last token unless the trailing blank scores higher.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import build as _build

NEG = -1e30
MAX_STATES = 4096  # kMaxStates in csrc/ctc.cu: 4 states a thread, 1024 threads
# the warp path's constants, each csrc/ctc.cu's of the name in the comment
WARP_LANES = 32  # kLanes
WARP_MAX_K = 8  # kMaxK: states a lane
WARP_MAX_STATES = WARP_LANES * WARP_MAX_K  # kWarpMaxStates
MOVE_BITS = 2  # kMoveBits: 0 stay, 1 advance, 2 skip
GROUP_STEPS = 4  # kGroupSteps: steps a lane's 64-bit word of moves
RING_STAGES = 4  # kStages
RING_MAX_ROWS = 8  # kMaxRows: emission rows a stage
RING_FLOATS = 1024  # kRingFloats
BARRIER_BYTES = 64  # kBarrierBytes
WARP_MAX_WINDOWS = 8  # kMaxWindows: windows (warps) a block
SHARED_MAX = 232448  # kSharedMax: a block's shared bytes on Hopper

# Character vocabulary for transcript encoding (wav2vec2-style: a word
# delimiter token separates words; blank is index 0 by convention here —
# pass `blank=` to match a checkpoint whose blank sits elsewhere).
WORD_DELIM = "|"


def char_vocab() -> Dict[str, int]:
    """Default char vocab: <blank>=0, '|'=1, a-z, apostrophe."""
    toks = [WORD_DELIM] + list("abcdefghijklmnopqrstuvwxyz") + ["'"]
    return {t: i + 1 for i, t in enumerate(toks)}


def encode_transcript(text: str, vocab: Dict[str, int]):
    """-> (tokens, words, word_spans): token ids with a word-delimiter
    between words, the normalized word list, and each word's [a, b) span
    in the token sequence."""
    words = [w for w in re.split(r"\s+", text.strip().lower()) if w]
    words = [re.sub(r"[^a-z']", "", w) for w in words]
    # drop characters the checkpoint vocab cannot emit (e.g. apostrophes in
    # several wav2vec2 fine-tunes) instead of KeyError-ing mid-alignment;
    # words with no encodable characters are dropped entirely
    words = ["".join(ch for ch in w if ch in vocab) for w in words]
    words = [w for w in words if w]
    delim = vocab.get(WORD_DELIM)
    tokens: List[int] = []
    spans = []
    for k, w in enumerate(words):
        if k and delim is not None:
            tokens.append(delim)
        a = len(tokens)
        tokens.extend(vocab[ch] for ch in w)
        spans.append((a, len(tokens)))
    return tokens, words, spans


def lattice(tokens: np.ndarray, blank: int):
    """-> (labels_ext [S] int32, allow_skip [S] bool, need): the CTC
    lattice of N >= 1 tokens (S = 2N + 1) and the frames it needs (N plus
    a blank between equal neighbours)."""
    n = len(tokens)
    labels_ext = np.full(2 * n + 1, blank, np.int32)
    labels_ext[1::2] = tokens
    allow_skip = np.zeros(2 * n + 1, bool)
    # skip s-2 -> s for token states whose token differs from the previous
    allow_skip[3::2] = tokens[1:] != tokens[:-1]
    need = n + int((tokens[1:] == tokens[:-1]).sum())
    return labels_ext, allow_skip, need


# ---------------------------------------------------------------- plain


def viterbi_plain(log_probs: torch.Tensor, labels_ext: torch.Tensor,
                  allow_skip: torch.Tensor):
    """One window: log_probs [T, V] f32, labels_ext [S] (S >= 2),
    allow_skip [S] bool -> (states [T] int32, score 0-d f32), the JAX
    package's ``_viterbi_fn`` step for step on the tensors' device."""
    dev = log_probs.device
    t_len = log_probs.shape[0]
    s_len = labels_ext.shape[0]
    emit = log_probs[:, labels_ext.to(torch.int64)]  # [T, S]
    neg = torch.full((s_len,), NEG, dtype=torch.float32, device=dev)
    alpha = torch.where(torch.arange(s_len, device=dev) <= 1, emit[0], neg)
    bps = torch.empty((max(t_len - 1, 0), s_len), dtype=torch.int64,
                      device=dev)
    for t in range(1, t_len):
        adv = torch.cat([neg[:1], alpha[:-1]])
        skip = torch.where(allow_skip, torch.cat([neg[:2], alpha[:-2]]), neg)
        # first maximum in the order stay, advance, skip (jnp.argmax)
        best, bp = alpha, torch.zeros(s_len, dtype=torch.int64, device=dev)
        take = adv > best
        best, bp = torch.where(take, adv, best), torch.where(take, 1, bp)
        take = skip > best
        best, bp = torch.where(take, skip, best), torch.where(take, 2, bp)
        bps[t - 1] = bp
        alpha = best + emit[t]
    # final state: last token or trailing blank, ties to the last token
    state = torch.where(alpha[s_len - 1] >= alpha[s_len - 2],
                        s_len - 1, s_len - 2).reshape(1)
    score = alpha[state[0]]
    states = torch.empty(t_len, dtype=torch.int64, device=dev)
    states[t_len - 1] = state[0]
    for t in range(t_len - 2, -1, -1):
        state = state - bps[t].gather(0, state)
        states[t] = state[0]
    return states.to(torch.int32), score


def ctc_viterbi_plain(log_probs: torch.Tensor, t_len: torch.Tensor,
                      labels_ext: torch.Tensor, allow_skip: torch.Tensor,
                      s_len: torch.Tensor):
    """The batch of ``ctc_viterbi``, a window at a time through
    ``viterbi_plain``: states [B, Tmax] int32 (-1 past a window's T) and
    score [B] f32."""
    b, tmax, _ = log_probs.shape
    states = torch.full((b, tmax), -1, dtype=torch.int32,
                        device=log_probs.device)
    scores = torch.empty(b, dtype=torch.float32, device=log_probs.device)
    for i, (t, s) in enumerate(zip(t_len.tolist(), s_len.tolist())):
        states[i, :t], scores[i] = viterbi_plain(
            log_probs[i, :t], labels_ext[i, :s], allow_skip[i, :s])
    return states, scores


# ---------------------------------------------------------------- kernel


def ring_rows(v: int) -> int:
    """Emission rows a stage of the warp path's ring (``ring_rows`` in
    csrc/ctc.cu): RING_FLOATS over the stages, in whole groups of
    GROUP_STEPS rows: 4 or RING_MAX_ROWS = 8 rows of V floats."""
    groups = RING_FLOATS // (RING_STAGES * GROUP_STEPS * v)
    return GROUP_STEPS * max(1, min(RING_MAX_ROWS // GROUP_STEPS, groups))


def window_bytes(tmax: int, v: int) -> int:
    """A window's shared bytes on the warp path (``window_bytes`` in
    csrc/ctc.cu): its mbarriers, the emission ring, the moves of Tmax - 1
    steps (16 bits a lane a step, in 64-bit words of GROUP_STEPS steps)
    and the path's byte a frame and a group past the last, rounded up to
    128 bytes."""
    ring = RING_STAGES * ring_rows(v) * v * 4
    moves = -(-(tmax - 1) // GROUP_STEPS) * WARP_LANES * 8
    path = -(-(tmax + GROUP_STEPS) // 16) * 16
    return -(-(BARRIER_BYTES + ring + moves + path) // 128) * 128


def viterbi_geometry(b: int, tmax: int, smax: int, v: int,
                     aligned: bool = True) -> dict:
    """The launch of ``ctc_viterbi`` for B windows of at most Tmax frames
    and Smax states over V labels.

    ``path`` "warp" where Smax <= WARP_MAX_STATES and a window's shared
    bytes (``window_bytes``) fit SHARED_MAX: ``k`` states a lane
    (ceil(Smax / 32)), ``rows`` emission rows a ring stage, ``windows`` a
    block (as many as fit SHARED_MAX, at most WARP_MAX_WINDOWS: the
    600-window track takes the same time at 1 to 8, tools/ctc_probe.py),
    ``bulk`` (bulk copies where V % 4 == 0 and the emissions are
    ``aligned`` to 16 bytes, else 4-byte copies), no scratch. Else
    ``path`` "block": a block a window, ``scratch_bytes`` of int8
    back-pointers."""
    if not 2 <= smax <= MAX_STATES or tmax < 1 or v < 1 or b < 0:
        raise ValueError(f"ctc_viterbi: B {b}, Tmax {tmax}, Smax {smax}, "
                         f"V {v}")
    one = window_bytes(tmax, v)
    if smax <= WARP_MAX_STATES and one <= SHARED_MAX:
        windows = min(WARP_MAX_WINDOWS, SHARED_MAX // one)
        return {"path": "warp", "k": -(-smax // WARP_LANES),
                "rows": ring_rows(v), "windows": windows,
                "window_bytes": one, "shared_bytes": windows * one,
                "bulk": aligned and v % 4 == 0, "blocks": -(-b // windows),
                "scratch_bytes": 0}
    return {"path": "block", "shared_bytes": 2 * 4 * smax, "blocks": b,
            "scratch_bytes": b * (tmax - 1) * smax}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ctc")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.st_ctc_viterbi_warp.restype = i
    lib.st_ctc_viterbi_warp.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p,
                                        p, p]
    lib.st_ctc_viterbi_block.restype = i
    lib.st_ctc_viterbi_block.argtypes = [p, p, p, p, p, i, i, i, i, p, p, p,
                                         p]
    lib.st_ctc_step_probe.restype = i
    lib.st_ctc_step_probe.argtypes = [i, i, p, p]
    lib.st_ctc_block_step_probe.restype = i
    lib.st_ctc_block_step_probe.argtypes = [i, i, p, p]
    return lib


def ctc_viterbi(log_probs: torch.Tensor, t_len: torch.Tensor,
                labels_ext: torch.Tensor, allow_skip: torch.Tensor,
                s_len: torch.Tensor):
    """CTC Viterbi over a batch of windows.

    log_probs [B, Tmax, V] f32; t_len [B] int32 (1..Tmax); labels_ext
    [B, Smax] int32 (in [0, V)); allow_skip [B, Smax] bool; s_len [B]
    int32 (2..Smax). -> (states [B, Tmax] int32, -1 past a window's T;
    score [B] f32). A window's rows past its T and states past its S are
    never read. Launches the CUDA kernel for CUDA tensors, one launch for
    the batch on the path ``viterbi_geometry`` picks (the warp path for
    Smax <= 256 and a Tmax that fits shared memory, with no scratch; the
    block path otherwise, with B x (Tmax - 1) x Smax bytes of scratch);
    ``ctc_viterbi_plain`` for CPU tensors. The lengths and labels are the
    caller's to keep in range (``pack_windows`` checks them); the kernel
    clamps them to its arrays, so that no input makes it read or write
    out of bounds."""
    if log_probs.device.type == "cpu":
        return ctc_viterbi_plain(log_probs, t_len, labels_ext, allow_skip,
                                 s_len)
    if log_probs.device.type != "cuda":
        raise ValueError(f"ctc_viterbi: unsupported device "
                         f"{log_probs.device}")
    if log_probs.dim() != 3 or log_probs.dtype != torch.float32:
        raise ValueError("ctc_viterbi: log_probs must be [B, Tmax, V] "
                         "float32")
    b, tmax, v = log_probs.shape
    smax = labels_ext.shape[-1]
    for name, x, shape, dtype in (
            ("t_len", t_len, (b,), torch.int32),
            ("labels_ext", labels_ext, (b, smax), torch.int32),
            ("allow_skip", allow_skip, (b, smax), torch.bool),
            ("s_len", s_len, (b,), torch.int32)):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"ctc_viterbi: {name} must be {list(shape)} "
                             f"{dtype}, got {list(x.shape)} {x.dtype}")
        if x.device != log_probs.device:
            raise ValueError(f"ctc_viterbi: {name} on {x.device}, "
                             f"log_probs on {log_probs.device}")
    if not 2 <= smax <= MAX_STATES:
        raise ValueError(f"ctc_viterbi: 2..{MAX_STATES} states, got {smax}")
    if tmax < 1 or v < 1:
        raise ValueError(f"ctc_viterbi: empty emissions {[b, tmax, v]}")
    log_probs = log_probs.contiguous()
    labels_ext = labels_ext.contiguous()
    allow_skip = allow_skip.contiguous()
    states = torch.empty((b, tmax), dtype=torch.int32,
                         device=log_probs.device)
    scores = torch.empty(b, dtype=torch.float32, device=log_probs.device)
    if b == 0:
        return states, scores
    dev = log_probs.device
    geo = viterbi_geometry(b, tmax, smax, v, log_probs.data_ptr() % 16 == 0)
    args = (log_probs.data_ptr(), t_len.data_ptr(), labels_ext.data_ptr(),
            allow_skip.data_ptr(), s_len.data_ptr(), b, tmax, v, smax)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if geo["path"] == "warp":
            rc = _lib().st_ctc_viterbi_warp(
                *args, geo["windows"], int(geo["bulk"]),
                states.data_ptr(), scores.data_ptr(), stream)
        else:
            # back-pointers (0 stay, 1 advance, 2 skip), written once,
            # read once
            bps = torch.empty((b, tmax - 1, smax), dtype=torch.int8,
                              device=dev)
            rc = _lib().st_ctc_viterbi_block(
                *args, bps.data_ptr(), states.data_ptr(), scores.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"ctc_viterbi: CUDA launch failed with error {rc}")
    ctc_viterbi.launches += 1
    ctc_viterbi.path_launches[geo["path"]] += 1
    return states, scores


ctc_viterbi.launches = 0
ctc_viterbi.path_launches = {"warp": 0, "block": 0}


def viterbi_step_probe(steps: int, smax: int, device="cuda",
                       path: Optional[str] = None) -> torch.Tensor:
    """A probe of the scan's floor, on no path: ``steps`` dependent steps
    of the forward recurrence over one window of ``smax`` states, with no
    emission load and no move stored -> the last alpha [smax] f32. ``path``
    "warp" (smax <= 256: the warp path's step, its shuffles, max and add in
    one warp) or "block" (the block path's, a shared round trip and a
    barrier in its block); None takes the path ``ctc_viterbi`` takes for
    smax states. Timed at two step counts, its slope is the latency of one
    step. CUDA only."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"viterbi_step_probe: a CUDA device, got {dev}")
    if path is None:
        path = "warp" if smax <= WARP_MAX_STATES else "block"
    top = WARP_MAX_STATES if path == "warp" else MAX_STATES
    if steps < 0 or not 2 <= smax <= top or path not in ("warp", "block"):
        raise ValueError(f"viterbi_step_probe: steps {steps}, smax {smax}, "
                         f"path {path}")
    out = torch.empty(smax, dtype=torch.float32, device=dev)
    probe = _lib().st_ctc_step_probe if path == "warp" \
        else _lib().st_ctc_block_step_probe
    with torch.cuda.device(dev):
        rc = probe(steps, smax, out.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"viterbi_step_probe: CUDA launch failed with "
                           f"error {rc}")
    return out


# ---------------------------------------------------------------- align


def pack_windows(windows: Sequence[Tuple[np.ndarray, Sequence[int]]],
                 blank: int = 0):
    """[(log_probs [T, V], tokens)] with N >= 1 tokens each -> numpy
    (log_probs [B, Tmax, V] f32 zero-padded, t_len [B] int32, labels_ext
    [B, Smax] int32, allow_skip [B, Smax] bool, s_len [B] int32). Raises
    ValueError where T cannot realize the tokens or a label is outside
    the vocabulary."""
    v = windows[0][0].shape[1]
    lats = []
    for lp, tokens in windows:
        tokens = np.asarray(tokens, np.int32)
        labels, skip, need = lattice(tokens, blank)
        t = lp.shape[0]
        if t < need:
            raise ValueError(f"{t} frames cannot realize {len(tokens)} "
                             f"tokens ({need} lattice-mandatory frames)")
        if lp.shape[1] != v or labels.min() < 0 or labels.max() >= v:
            raise ValueError(f"labels {labels.min()}..{labels.max()} "
                             f"outside a vocabulary of {lp.shape[1]}")
        lats.append((labels, skip))
    b = len(windows)
    tmax = max(lp.shape[0] for lp, _ in windows)
    smax = max(len(labels) for labels, _ in lats)
    log_probs = np.zeros((b, tmax, v), np.float32)
    labels_ext = np.full((b, smax), blank, np.int32)
    allow_skip = np.zeros((b, smax), bool)
    for i, ((lp, _), (labels, skip)) in enumerate(zip(windows, lats)):
        log_probs[i, :lp.shape[0]] = lp
        labels_ext[i, :len(labels)] = labels
        allow_skip[i, :len(skip)] = skip
    t_len = np.array([lp.shape[0] for lp, _ in windows], np.int32)
    s_len = np.array([len(labels) for labels, _ in lats], np.int32)
    return log_probs, t_len, labels_ext, allow_skip, s_len


def ctc_forced_align_batch(windows: Sequence[Tuple[np.ndarray,
                                                   Sequence[int]]],
                           blank: int = 0, device=None):
    """``ctc_forced_align`` of every (log_probs, tokens) window, the
    windows with tokens in one ``ctc_viterbi`` call on ``device`` (None:
    the CUDA device) -> [(token_index_per_frame [T] int32, path_score)].
    Every window is padded to the largest T and S of the call, so the
    card holds B * Tmax * V * 4 bytes of emissions (and, on the block
    path, B * (Tmax - 1) * Smax bytes of back-pointers): one long window
    raises them for all."""
    out: List[Optional[tuple]] = [None] * len(windows)
    todo = []
    for i, (lp, tokens) in enumerate(windows):
        if len(tokens) == 0:
            out[i] = (np.full(lp.shape[0], -1, np.int32),
                      float(lp[:, blank].sum()))
        else:
            todo.append(i)
    if not todo:
        return out
    from ..client import _resolve_device

    dev = _resolve_device(device)
    packed = pack_windows([(np.asarray(windows[i][0], np.float32),
                            windows[i][1]) for i in todo], blank)
    args = [torch.from_numpy(x).to(dev) for x in packed]
    states, scores = ctc_viterbi(*args)
    states, scores = states.cpu().numpy(), scores.cpu().numpy()
    for k, i in enumerate(todo):
        st = states[k, :windows[i][0].shape[0]]
        tok_idx = np.where(st % 2 == 1, (st - 1) // 2, -1)
        out[i] = (tok_idx.astype(np.int32), float(scores[k]))
    return out


def ctc_forced_align(log_probs: np.ndarray, tokens: Sequence[int],
                     blank: int = 0, device=None):
    """Viterbi-align `tokens` to CTC emissions.

    log_probs: [T, V] log-softmax emissions. tokens: N label ids (no
    blanks). Returns (token_index_per_frame [T] int32 with -1 on blank
    frames, path_score float). Requires T >= number of lattice-mandatory
    frames (N plus a blank between equal neighbors). ``device``: where
    the DP runs (None: the CUDA device)."""
    return ctc_forced_align_batch([(log_probs, tokens)], blank, device)[0]


@dataclasses.dataclass
class AlignedWord:
    """gentle-style word record: absolute seconds + mean per-char emission
    log-prob (0 is perfect; ~log(1/V) is chance — see `success` below)."""

    word: str
    start: float
    end: float
    score: float

    def success(self, thresh: float = -4.0) -> bool:
        """gentle 'success' vs 'not-found-in-audio' analog."""
        return self.score > thresh


def align_windows_ctc(windows: Sequence[Tuple[np.ndarray, str, float]],
                      frame_s: float, vocab: Optional[Dict[str, int]] = None,
                      blank: int = 0, device=None) -> List[List[AlignedWord]]:
    """``align_transcript_ctc`` of every (log_probs, transcript, t0)
    window, with one ``ctc_viterbi`` call for all of them."""
    vocab = vocab or char_vocab()
    enc = [encode_transcript(text, vocab) for _, text, _ in windows]
    todo = [i for i, (_, words, _) in enumerate(enc) if words]
    paths = ctc_forced_align_batch(
        [(windows[i][0], enc[i][0]) for i in todo], blank, device) \
        if todo else []
    out: List[List[AlignedWord]] = [[] for _ in windows]
    for i, (tok_idx, _) in zip(todo, paths):
        log_probs, _, t0 = windows[i]
        tokens, words, spans = enc[i]
        lp = np.asarray(log_probs)
        tok_arr = np.asarray(tokens)
        for w, (a, b) in zip(words, spans):
            frames = np.nonzero((tok_idx >= a) & (tok_idx < b))[0]
            if len(frames) == 0:  # degenerate — shouldn't happen on valid T
                out[i].append(AlignedWord(w, t0, t0, float(NEG)))
                continue
            f0, f1 = int(frames[0]), int(frames[-1]) + 1
            score = float(np.mean(
                lp[frames, tok_arr[tok_idx[frames]]]))
            out[i].append(AlignedWord(w, t0 + f0 * frame_s,
                                      t0 + f1 * frame_s, score))
    return out


def align_transcript_ctc(log_probs: np.ndarray, transcript: str,
                         frame_s: float, vocab: Optional[Dict[str, int]]
                         = None, blank: int = 0,
                         t0: float = 0.0, device=None) -> List[AlignedWord]:
    """Per-word alignment of `transcript` against CTC emissions.

    log_probs: [T, V] log-softmax acoustic frames of duration `frame_s`
    seconds starting at absolute time `t0`. Returns one AlignedWord per
    transcript word; a word's score is the mean emission log-prob of its
    aligned character frames (low = not actually spoken there)."""
    return align_windows_ctc([(log_probs, transcript, t0)], frame_s, vocab,
                             blank, device)[0]


def wav2vec2_log_probs(samples: np.ndarray, sample_rate: int,
                       model_name_or_path: str):
    """Emissions from a transformers Wav2Vec2ForCTC checkpoint (weights
    must be on disk — zero-egress environments can't download). Returns
    (log_probs [T, V], frame_s, vocab, blank). The returned vocab maps
    lowercase chars + '|' to ids so it plugs into align_transcript_ctc."""
    from transformers import Wav2Vec2ForCTC, Wav2Vec2Processor

    processor = Wav2Vec2Processor.from_pretrained(model_name_or_path)
    model = Wav2Vec2ForCTC.from_pretrained(model_name_or_path)
    model.eval()
    if sample_rate != 16000:
        idx = np.linspace(0, len(samples) - 1,
                          int(len(samples) * 16000 / sample_rate))
        samples = np.interp(idx, np.arange(len(samples)), samples)
        sample_rate = 16000
    inputs = processor(samples, sampling_rate=sample_rate,
                       return_tensors="pt")
    with torch.no_grad():
        logits = model(inputs.input_values).logits[0]
    log_probs = torch.log_softmax(logits, dim=-1).numpy()
    frame_s = len(samples) / sample_rate / log_probs.shape[0]
    hf_vocab = processor.tokenizer.get_vocab()
    vocab = {k.lower(): v for k, v in hf_vocab.items()
             if len(k) == 1 or k == WORD_DELIM}
    blank = hf_vocab.get(processor.tokenizer.pad_token, 0)
    return log_probs, frame_s, vocab, blank
