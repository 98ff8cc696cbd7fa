"""Legacy-module extras: crop classification, face landmarks, and
transcript alignment.

Reference parity:
  old/clothing_detection.py / old/hairstyle_detection.py — bbox-crop
  attribute classifiers; the generic machinery is one ``CropClassify`` op
  over the model registry (ops/nn_generic.py). DetectClothing /
  DetectHairStyle are in ops/clothing.py.
  old/face_landmark_detection.py — per-face landmarks; implemented with
  the MTCNN O-Net's landmark head (5 points), which is what the modern
  MTCNN stack provides natively.
  old/transcript_alignment.py — gentle-based forced alignment (an external
  ASR server). Here: a self-contained coarse aligner that cross-correlates
  audio speech energy against caption activity to estimate the global
  caption offset — the windowed-alignment UX without the ASR dependency.

The JAX package's ops/legacy_extras.py (scannertools_tpu): the crops are
cut on the host with cv2 as there, go to the run's device in one copy and
through the net in one forward. ``TranscriptAligner`` and
``WordAlignment`` are numpy, copied; the aligner's CTC method
(``align_words_ctc``) aligns every caption window of a track in one
``ctc_viterbi`` launch (ops/ctc_align.py) where the JAX package runs one
jitted program a window.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

import numpy as np
import torch

from ..models import mtcnn as mtcnn_lib
from ..models.common import apply_net
from ..registry import register_op
from .faces import (_crop_resize_host, _device_state, _host_crops,
                    _run_device, _to_f32_frames)
from .nn_generic import get_model


@register_op("CropClassify", kind="host", outputs=("object",))
def crop_classify(ctx, frame, bboxes, model: str = "gender_levi_hassner",
                  input_size: int = 227, weights_path: Optional[str] = None,
                  categories: Sequence[str] = ()):
    """Crop each bbox, resize, classify with a registered model; returns
    per-frame lists of category names (or argmax ints without categories).
    The generic machinery behind the reference's clothing/hairstyle ops."""
    name, fwd = get_model(model)
    crops, src, out = _host_crops(
        _to_f32_frames(frame), bboxes,
        lambda f, b: _crop_resize_host(f, b, input_size))
    for row in out:  # degenerate crops: the first category
        for j in range(len(row)):
            row[j] = categories[0] if categories else 0
    if crops is not None:
        device = _run_device(ctx)
        logits = fwd(_device_state(name, weights_path, device),
                     torch.from_numpy(crops).to(device))
        labels = torch.argmax(logits, dim=-1).cpu().numpy()
        for lab, (i, j) in zip(labels, src):
            out[i][j] = categories[int(lab)] if categories else int(lab)
    return out


@register_op("DetectFaceLandmarks", kind="host", outputs=("object",))
def detect_face_landmarks(ctx, frame, bboxes,
                          weights_path: Optional[str] = None):
    """5-point landmarks from the MTCNN O-Net head, normalized to each
    bbox; returns per-face [5,2] arrays."""
    crops, src, out = _host_crops(
        _to_f32_frames(frame), bboxes,
        lambda f, b: _crop_resize_host(f, b, 48))
    for row in out:  # degenerate crops: zeros
        for j in range(len(row)):
            row[j] = np.zeros((5, 2), np.float32)
    if crops is not None:
        device = _run_device(ctx)
        state = _device_state("mtcnn", weights_path, device)
        x = torch.from_numpy((crops - 127.5) * 0.0078125).to(device)
        lmk = apply_net(mtcnn_lib.ONet, state["onet"], x)[2].cpu().numpy()
        for l, (i, j) in zip(lmk, src):
            out[i][j] = l.reshape(2, 5).T.astype(np.float32)  # [5,(x,y)]
    return out


# ------------------------------------------------------- transcript align

class TranscriptAligner:
    """Coarse caption↔audio alignment (old/transcript_alignment.py UX).

    The reference drives the external `gentle` forced-alignment server over
    sliding caption/audio windows (old/transcript_alignment.py:206-342).
    Without ASR, this estimates the global time offset that maximizes the
    correlation between audio speech energy and caption activity, then
    shifts caption timestamps. ``win_size`` controls the energy resolution.
    """

    def __init__(self, win_size: float = 0.5, max_shift: float = 30.0):
        self.win_size = win_size
        self.max_shift = max_shift

    def estimate_offset(self, samples: np.ndarray, sample_rate: int,
                        captions) -> float:
        """-> seconds to ADD to caption times to align them to the audio."""
        ws = self.win_size
        n_win = max(1, int(len(samples) / sample_rate / ws))
        energy = np.zeros(n_win)
        per = int(ws * sample_rate)
        for i in range(n_win):
            seg = samples[i * per:(i + 1) * per]
            energy[i] = float(np.sqrt(np.mean(seg ** 2))) if len(seg) else 0.0
        # binarized speech activity vs caption activity
        act_audio = (energy > np.median(energy)).astype(np.float32)
        act_cap = np.zeros(n_win, np.float32)
        for c in captions:
            a = int(c.start / ws)
            b = int(np.ceil(c.end / ws))
            act_cap[max(a, 0):min(b, n_win)] = 1.0
        max_lag = min(int(self.max_shift / ws), n_win - 1)
        best_lag, best_score = 0, -np.inf
        for lag in range(-max_lag, max_lag + 1):
            if lag >= 0:
                score = float(np.dot(act_audio[lag:], act_cap[: n_win - lag]))
            else:
                score = float(np.dot(act_audio[: n_win + lag], act_cap[-lag:]))
            score -= 1e-6 * abs(lag)  # ties resolve to the smallest shift
            if score > best_score:
                best_score, best_lag = score, lag
        return best_lag * ws

    def align(self, samples: np.ndarray, sample_rate: int, captions):
        """Returns captions with shifted start/end times."""
        import dataclasses

        off = self.estimate_offset(samples, sample_rate, captions)
        return [dataclasses.replace(c, start=c.start + off, end=c.end + off)
                for c in captions], off

    # ------------------------------------------------ per-word alignment

    FRAME_S = 0.05  # DP frame resolution (50 ms)

    @staticmethod
    def _syllables(word: str) -> int:
        groups = re.findall(r"[aeiouyAEIOUY]+", word)
        return max(1, len(groups))

    def align_words(self, samples: np.ndarray, sample_rate: int, captions):
        """Per-word timings — the reference's gentle role
        (old/transcript_alignment.py:206-342 drives gentle's forced aligner
        per sliding window and stores word-level (start, end)).

        Self-contained equivalent: after the global offset, each caption
        window's words are placed by a monotonic dynamic program over 50 ms
        energy frames — word durations follow a syllable-count prior, and
        boundaries are pulled toward energy dips (inter-word pauses), the
        acoustic cue a lexicon-free aligner has. Returns a list of
        ``WordAlignment(word, start, end, score)``; words in silent windows
        get score 0 (gentle's not-found-in-audio analog).
        """
        off = self.estimate_offset(samples, sample_rate, captions)
        fs = self.FRAME_S
        per = max(1, int(fs * sample_rate))
        n_fr = max(1, len(samples) // per)
        seg = samples[: n_fr * per].reshape(n_fr, per)
        energy = np.sqrt(np.mean(seg.astype(np.float64) ** 2, axis=1))
        e_max = energy.max() or 1.0
        energy = energy / e_max
        speech_thresh = max(0.05, float(np.median(energy)) * 0.5)

        out = []
        for c in captions:
            words = [w for w in re.split(r"\s+", c.line.strip()) if w]
            if not words:
                continue
            a = int(round((c.start + off) / fs))
            b = int(round((c.end + off) / fs))
            a = max(0, min(a, n_fr - 1))
            b = max(a + 1, min(b, n_fr))
            win = energy[a:b]
            F = len(win)
            W = len(words)
            if F < W:  # window too short for DP — spread uniformly
                dur = (b - a) * fs / W
                for j, w in enumerate(words):
                    t0 = (a * fs) + j * dur
                    out.append(WordAlignment(w, t0, t0 + dur, 0.0))
                continue
            syl = np.array([self._syllables(w) for w in words], np.float64)
            prior = syl / syl.sum() * F  # frames per word
            # dipness: how much of a local energy minimum each frame is
            pad = np.pad(win, 1, mode="edge")
            dip = np.maximum(0, (pad[:-2] + pad[2:]) / 2 - win)
            # DP over word-end boundaries. cost[w][f] = best cost of
            # placing words 0..w with word w ending at frame f.
            big = 1e18
            cost = np.full((W, F + 1), big)
            back = np.zeros((W, F + 1), np.int32)
            alpha, beta = 1.0, 4.0
            bonus = beta * np.pad(dip, (0, 1))  # boundary-at-dip reward
            prev = np.full(F + 1, big)
            prev[0] = 0.0
            for wi in range(W):
                for f in range(wi + 1, F + 1):
                    # candidate word starts f' in [wi, f)
                    starts = np.arange(wi, f)
                    cand = prev[wi:f] + alpha * np.abs(
                        (f - starts) - prior[wi])
                    k = int(np.argmin(cand))
                    cost[wi, f] = cand[k] - bonus[f]
                    back[wi, f] = wi + k
                prev = cost[wi]
            # backtrack from the forced final boundary F
            bounds = [F]
            f = F
            for wi in range(W - 1, -1, -1):
                f = int(back[wi, f])
                bounds.append(f)
            bounds = bounds[::-1]  # W+1 boundaries in frames, rel. to a
            for j, w in enumerate(words):
                f0, f1 = bounds[j], bounds[j + 1]
                score = float(np.mean(win[f0:f1] > speech_thresh)) \
                    if f1 > f0 else 0.0
                out.append(WordAlignment(
                    w, (a + f0) * fs, (a + max(f1, f0 + 1)) * fs, score))
        return out

    # ------------------------------------------- ASR forced alignment
    def align_words_ctc(self, captions, log_probs, frame_s: float,
                        vocab=None, blank: int = 0, margin_s: float = 1.0,
                        device=None):
        """gentle-equivalent forced alignment from CTC acoustic emissions
        (ops/ctc_align.py): per caption window, Viterbi-align the words to
        the emission slice covering the (offset-corrected) caption span
        plus ``margin_s`` slack on each side — the reference's sliding
        gentle windows (old/transcript_alignment.py:206-264). Emissions
        come from any char-CTC model: `ctc_align.wav2vec2_log_probs` runs
        a transformers Wav2Vec2ForCTC checkpoint when its weights are on
        disk, or pass logits computed elsewhere. Returns
        ``ctc_align.AlignedWord`` records with absolute times and acoustic
        scores (word.success() is gentle's success/not-found-in-audio).
        Every window goes to one ``ctc_viterbi`` call on ``device`` (None:
        the CUDA device); the records equal those of
        ``align_transcript_ctc`` run a window at a time."""
        from .ctc_align import align_windows_ctc

        n_fr = log_probs.shape[0]
        windows = []
        for c in captions:
            a = max(0, int((c.start - margin_s) / frame_s))
            b = min(n_fr, int(np.ceil((c.end + margin_s) / frame_s)))
            if b <= a:
                continue
            windows.append((log_probs[a:b], c.line, a * frame_s))
        per_window = align_windows_ctc(windows, frame_s, vocab=vocab,
                                       blank=blank, device=device)
        return [w for words in per_window for w in words]


@dataclasses.dataclass
class WordAlignment:
    """gentle-style word record (word, absolute start/end seconds, score =
    fraction of the word interval that is speech-active)."""

    word: str
    start: float
    end: float
    score: float
