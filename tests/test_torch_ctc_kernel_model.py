"""A numpy model of the ``ctc_viterbi`` kernel's warp path
(scannertools_tpu_torch/kernels/csrc/ctc.cu) held to the jitted JAX
``_viterbi_fn`` (scannertools_tpu/ops/ctc_align.py) and to the port's
``viterbi_plain``, on the CPU.

The model follows the kernel's decomposition: lane l of the warp owns the
K = ceil(Smax / 32) contiguous states l * K + k; a step reads s - 1 and
s - 2 from the lane's own values and, at its first two states, from lane
l - 1 (lane l - 2 when K = 1) as ``__shfl_up_sync`` gives them (a lane
below the shift gets its own value back); the three moves of a state go
in the order stay, advance, skip by strict ``>``; a lane packs its K moves,
2 bits each, into 16 bits a step and 4 steps into a 64-bit word; the
backtrace walks those words from the final state a group at a time, two
lanes' words a group joined into one field a row, and a group again a row
at a time where its path falls below both lanes. The constants (lanes,
the K limit, bits a move, steps a word, the ring, the shared-memory
limit) are read from ctc.cu, and ``viterbi_geometry``'s choice of path
and sizes is held to them. Inputs are made from a seed with
numpy.

Tolerance: none. Paths equal and scores ``==`` on float32: a cell is a max
of three values and one float32 add, in numpy as in the kernel, the JAX
program and the plain version.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from scannertools_tpu.ops import ctc_align as J
from scannertools_tpu_torch.ops import ctc_align as P
from scannertools_tpu_torch.tools.timing import (CTC_LANE_EDGES,
                                                 ctc_edge_batch,
                                                 planted_emissions)

NEG = np.float32(-1e30)
LANE_EDGES = list(CTC_LANE_EDGES)


def _ctc_const(name: str) -> int:
    """``constexpr <int type> <name> = <int>;`` of ctc.cu."""
    text = (pathlib.Path(P.__file__).resolve().parent.parent / "kernels"
            / "csrc" / "ctc.cu").read_text()
    found = re.findall(rf"constexpr \w+ {name} = ([^;]+);", text)
    assert len(found) == 1, (name, found)
    return int(found[0])


# ------------------------------------------------------------ the model


def lanes_of(smax: int) -> int:
    return -(-smax // P.WARP_LANES)


def shfl_up(x: np.ndarray, delta: int) -> np.ndarray:
    """``__shfl_up_sync`` over a warp's values [32]: lane l gets lane
    l - delta's value, lanes below delta their own."""
    out = x.copy()
    out[delta:] = x[:-delta]
    return out


def from_below(a: np.ndarray):
    """The kernel's ``from_below``: a [32, K] -> (up1, up2) [32], the
    values of states l * K - 1 and l * K - 2; lane 0's up1 is NEG."""
    k = a.shape[1]
    up1 = shfl_up(a[:, k - 1], 1)
    up2 = shfl_up(a[:, k - 2], 1) if k >= 2 else shfl_up(a[:, 0], 2)
    up1[0] = NEG
    return up1, up2


def pack_moves(moves: np.ndarray) -> np.ndarray:
    """moves [32, K] in {0, 1, 2} -> a uint16 a lane, state k's move at
    bits 2k, 2k + 1."""
    word = np.zeros(moves.shape[0], np.uint32)
    for k in range(moves.shape[1]):
        word |= moves[:, k].astype(np.uint32) << (P.MOVE_BITS * k)
    assert word.max(initial=0) < 1 << 16
    return word.astype(np.uint16)


def group_words(words: np.ndarray) -> np.ndarray:
    """A window's step words [T - 1, 32] uint16 -> the kernel's 64-bit
    words [ceil((T - 1) / 4), 32]: step r at bits 16 * (r % 4)."""
    groups = np.zeros((-(-len(words) // P.GROUP_STEPS), P.WARP_LANES),
                      np.uint64)
    for r, w in enumerate(words):
        groups[r // P.GROUP_STEPS] |= w.astype(np.uint64) << np.uint64(
            16 * (r % P.GROUP_STEPS))
    return groups


def move_of(words: np.ndarray, state: int, k: int) -> int:
    """The move into ``state`` from a step's packed words [32]."""
    owner = state // k
    return int(words[owner] >> (P.MOVE_BITS * (state - owner * k))) & 3


def walk_group(groups, path, g, owner, k, k_lane):
    """The kernel's ``walk_group``: group g a row at a time from state
    owner * K + k, reading a lane's word again where the path leaves the
    lane -> (owner, k) at frame 4 g."""
    word = int(groups[g, owner])
    for i in range(P.GROUP_STEPS - 1, -1, -1):
        k -= (word >> (16 * i + P.MOVE_BITS * k)) & 3
        if k < 0:
            while k < 0:
                k += k_lane
                owner -= 1
            word = int(groups[g, owner])
        path[g * P.GROUP_STEPS + i] = owner * k_lane + k
    return owner, k


def walk_back(groups: np.ndarray, state: int, t: int, k_lane: int):
    """The kernel's ``walk_back``: the groups from the last (rows past the
    window's last are 0, stay); a group's rows read from the words of the
    path's lane and the one below, joined into one 32-bit field a row, the
    state q counted from the lower lane's first; a group in which q falls
    below 0 walked again a row at a time -> (path [t] int32, the groups
    walked again)."""
    t = int(t)
    path = np.full(t + P.GROUP_STEPS, -7, np.int64)  # the walk writes past
    path[t - 1] = state
    owner, k = divmod(int(state), int(k_lane))
    q = k + k_lane
    redone = []
    for g in range((t - 2) // P.GROUP_STEPS if t >= 2 else -1, -1, -1):
        hi = int(groups[g, owner])
        lo = int(groups[g, owner - 1]) if owner > 0 else 0
        entry = q
        for i in range(P.GROUP_STEPS - 1, -1, -1):
            field = ((lo >> (16 * i)) & 0xffff) | \
                (((hi >> (16 * i)) & 0xffff) << (P.MOVE_BITS * k_lane))
            shift = P.MOVE_BITS * q
            q -= (field >> shift) & 3 if 0 <= shift < 32 else 0
            path[g * P.GROUP_STEPS + i] = (owner - 1) * k_lane + q
        if q < 0:
            redone.append(g)
            owner, k = walk_group(groups, path, g, owner, entry - k_lane,
                                  k_lane)
            q = k + k_lane
        elif q < k_lane:
            owner -= 1
            q += k_lane
    return path[:t].astype(np.int32), redone


def warp_model(lp: np.ndarray, labels: np.ndarray, skip: np.ndarray,
               t: int, s: int, smax: int):
    """One window on the warp path: lp [>= t, V] f32, labels and skip of
    the batch's Smax (only the first S read) -> (path [t] int32, score
    f32, packed moves [t - 1, 32] uint16 a step, before their grouping)."""
    v = lp.shape[1]
    k = lanes_of(smax)
    assert k <= P.WARP_MAX_K
    st = np.arange(P.WARP_LANES * k).reshape(P.WARP_LANES, k)
    on = st < s
    pad = np.zeros(st.size, np.int64)
    pad[:s] = labels[:s]
    lab = np.where(on, np.clip(pad.reshape(st.shape), 0, v - 1), 0)
    flags = np.zeros(st.size, bool)
    flags[:s] = skip[:s]
    may_skip = on & (st >= 2) & flags.reshape(st.shape)
    a = np.where(st <= 1, lp[0][lab], NEG).astype(np.float32)
    words = np.zeros((max(t - 1, 0), P.WARP_LANES), np.uint16)
    for step in range(1, t):
        up1, up2 = from_below(a)
        e = lp[step][lab]
        nxt = np.empty_like(a)
        moves = np.zeros(st.shape, np.int64)
        for j in range(k):
            best = a[:, j]
            adv = a[:, j - 1] if j >= 1 else up1
            take = adv > best
            best = np.where(take, adv, best)
            moves[:, j] = np.where(take, 1, 0)
            below = a[:, j - 2] if j >= 2 else (up1 if j == 1 else up2)
            skp = np.where(may_skip[:, j], below, NEG)
            take = skp > best
            best = np.where(take, skp, best)
            moves[:, j] = np.where(take, 2, moves[:, j])
            nxt[:, j] = best + e[:, j]
        words[step - 1] = pack_moves(moves)
        a = nxt
    flat = a.reshape(-1)
    state = s - 1 if flat[s - 1] >= flat[s - 2] else s - 2
    path, _ = walk_back(group_words(words), state, t, k)
    return path, np.float32(flat[state]), words


def numpy_pointers(lp, labels, skip, t, s):
    """The back-pointers [t - 1, S] of the lattice, written directly from
    the recurrence (stay, advance, skip; first maximum)."""
    e = lp[:t][:, labels[:s]]
    alpha = np.where(np.arange(s) <= 1, e[0], NEG).astype(np.float32)
    out = np.zeros((max(t - 1, 0), s), np.int64)
    for step in range(1, t):
        adv = np.concatenate([[NEG], alpha[:-1]]).astype(np.float32)
        skp = np.where(skip[:s] & (np.arange(s) >= 2),
                       np.concatenate([[NEG, NEG], alpha[:-2]]), NEG)
        cand = np.stack([alpha, adv, skp.astype(np.float32)])
        out[step - 1] = np.argmax(cand, axis=0)
        alpha = cand.max(axis=0) + e[step]
    return out


# ------------------------------------------------------------ inputs


def lattice_of(s: int, rng, v: int = 32):
    """labels_ext and allow_skip of S states: the lattice of ceil((S -
    1) / 2) tokens cut to S (an even S ends on a token state)."""
    n = max(1, s // 2)
    tokens = rng.integers(1, v, n)
    labels, skip, _ = P.lattice(tokens, 0)
    return tokens, labels[:s], skip[:s]


def hold(lp, labels, skip, t, s, smax=None):
    """The model at Smax against the jitted JAX program and the plain
    version: paths equal, scores ==."""
    smax = smax or s
    got, score, _ = warp_model(lp, labels, skip, t, s, smax)
    j_states, j_score = J._viterbi_fn(t, s, lp.shape[1])(
        lp[:t], labels[:s], skip[:s])
    np.testing.assert_array_equal(got, np.asarray(j_states))
    assert score == np.float32(j_score), (score, j_score)
    p_states, p_score = P.viterbi_plain(torch.from_numpy(lp[:t]),
                                        torch.from_numpy(labels[:s]),
                                        torch.from_numpy(skip[:s]))
    np.testing.assert_array_equal(got, p_states.numpy())
    assert score == p_score.item()


# ------------------------------------------------------------ constants


@pytest.mark.parametrize("name,value", [
    ("kLanes", P.WARP_LANES), ("kMaxK", P.WARP_MAX_K),
    ("kMoveBits", P.MOVE_BITS), ("kGroupSteps", P.GROUP_STEPS),
    ("kStages", P.RING_STAGES),
    ("kMaxRows", P.RING_MAX_ROWS), ("kRingFloats", P.RING_FLOATS),
    ("kBarrierBytes", P.BARRIER_BYTES), ("kMaxWindows", P.WARP_MAX_WINDOWS),
    ("kSharedMax", P.SHARED_MAX), ("kPerThread", 4), ("kMaxThreads", 1024)])
def test_constants_match_kernel_source(name, value):
    assert _ctc_const(name) == value


def test_limits_follow_from_the_constants():
    assert P.WARP_MAX_STATES == _ctc_const("kLanes") * _ctc_const("kMaxK")
    assert P.WARP_MAX_STATES == 256
    assert P.MOVE_BITS * P.WARP_MAX_K <= 16  # a lane's moves in a uint16
    assert P.RING_STAGES * 8 <= P.BARRIER_BYTES  # the stages' mbarriers
    assert P.GROUP_STEPS * 16 == 64  # a group's steps in a uint64
    # a window of 350 frames keeps its moves in 22.5 KB
    assert -(-(350 - 1) // P.GROUP_STEPS) * P.WARP_LANES * 8 == 22528


# ------------------------------------------------------------ lanes


@pytest.mark.parametrize("smax", LANE_EDGES[:-1])
def test_lanes_own_contiguous_states(smax):
    """Every state below Smax has one owner, lane s // K at register
    s % K, and the K of Smax is the template the kernel launches."""
    k = lanes_of(smax)
    assert k == P.viterbi_geometry(1, 10, smax, 32)["k"]
    owners = {}
    for lane in range(P.WARP_LANES):
        for j in range(k):
            owners.setdefault(lane * k + j, []).append((lane, j))
    assert all(owners[s] == [(s // k, s % k)] for s in range(smax))
    assert 32 * (k - 1) < smax <= 32 * k


@pytest.mark.parametrize("k", range(1, 9))
def test_shuffles_give_the_lane_below(k):
    """up1 and up2 of lane l are the flat alpha's l * K - 1 and l * K - 2
    wherever those states exist; lane 0's up1 is NEG (no state -1)."""
    rng = np.random.default_rng(k)
    a = rng.normal(size=(P.WARP_LANES, k)).astype(np.float32)
    flat = a.reshape(-1)
    up1, up2 = from_below(a)
    assert up1[0] == NEG
    for lane in range(1, P.WARP_LANES):
        assert up1[lane] == flat[lane * k - 1]
        if lane * k - 2 >= 0:
            assert up2[lane] == flat[lane * k - 2]


@pytest.mark.parametrize("k", range(1, 9))
def test_moves_pack_and_unpack(k):
    rng = np.random.default_rng(10 + k)
    moves = rng.integers(0, 3, (P.WARP_LANES, k))
    words = pack_moves(moves)
    assert words.dtype == np.uint16
    for s in range(P.WARP_LANES * k):
        assert move_of(words, s, k) == moves[s // k, s % k]


@pytest.mark.parametrize("steps", [1, 3, 4, 5, 349])
def test_moves_group_four_steps_to_a_word(steps):
    """Step r's 16 bits sit at 16 * (r % 4) of word r // 4 of its lane,
    the last group's unused steps zero."""
    rng = np.random.default_rng(steps)
    words = rng.integers(0, 1 << 12, (steps, P.WARP_LANES)).astype(np.uint16)
    groups = group_words(words)
    assert groups.shape == (-(-steps // 4), P.WARP_LANES)
    for r in range(steps):
        np.testing.assert_array_equal(
            (groups[r // 4] >> np.uint64(16 * (r % 4))) & np.uint64(0xffff),
            words[r])
    assert not (groups[-1] >> np.uint64(16 * (steps % 4 or 4))).any() \
        if steps % 4 else True


@pytest.mark.parametrize("k", range(1, 9))
def test_walk_back_through_groups(k):
    """Random valid moves (the state never below 0): the walk through the
    64-bit words, two lanes' a group, gives the path the per-step words
    give, and walks a group again exactly where its path falls below both
    lanes."""
    rng = np.random.default_rng(30 + k)
    s, t = P.WARP_LANES * k, 200
    moves = rng.choice(3, (t - 1, P.WARP_LANES, k), p=[0.6, 0.3, 0.1])
    state, want = s - 1, [s - 1]
    for r in range(t - 2, -1, -1):  # keep every step's move in range
        flat = moves[r].reshape(-1)
        flat[:state + 1] = np.minimum(flat[:state + 1],
                                      np.minimum(state, 2))
        state -= flat[state]
        moves[r] = flat.reshape(P.WARP_LANES, k)
        want.append(state)
    words = np.stack([pack_moves(m) for m in moves])
    path, redone = walk_back(group_words(words), s - 1, t, k)
    np.testing.assert_array_equal(path, want[::-1])
    # a group is walked again where its path falls below the lane under
    # the one it enters in
    want_redone = [g for g in range((t - 2) // 4, -1, -1)
                   if path[4 * g:4 * g + 4].min()
                   < (path[min(4 * g + 4, t - 1)] // k - 1) * k]
    assert redone == want_redone


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("s", LANE_EDGES)
def test_model_at_lane_edges_matches_jax_and_plain(s):
    """S on the lanes' edges, in a batch of Smax = S: the warp path's
    model for S <= 256; the block path above."""
    rng = np.random.default_rng(s)
    tokens, labels, skip = lattice_of(s, rng)
    t = P.lattice(tokens, 0)[2] + 7
    lp = planted_emissions(rng, tokens, t, 32)
    geo = P.viterbi_geometry(1, t, s, 32)
    if s > P.WARP_MAX_STATES:
        assert geo["path"] == "block"
        p_states, p_score = P.viterbi_plain(
            torch.from_numpy(lp), torch.from_numpy(labels),
            torch.from_numpy(skip))
        j_states, j_score = J._viterbi_fn(t, s, 32)(lp, labels, skip)
        np.testing.assert_array_equal(p_states.numpy(), np.asarray(j_states))
        assert p_score.item() == np.float32(j_score)
        return
    assert geo["path"] == "warp"
    hold(lp, labels, skip, t, s)


@pytest.mark.parametrize("s,smax", [(3, 33), (31, 64), (65, 256),
                                    (2, 256), (192, 193)])
def test_model_in_a_wider_batch(s, smax):
    """A window of S states in a batch of wider Smax (a larger K): states
    past S compute but never reach the path."""
    rng = np.random.default_rng(s + smax)
    tokens, labels, skip = lattice_of(s, rng)
    t = P.lattice(tokens, 0)[2] + 4
    lp = planted_emissions(rng, tokens, t, 32)
    labels = np.concatenate([labels, rng.integers(0, 32, smax - s)])
    skip = np.concatenate([skip, np.ones(smax - s, bool)])
    hold(lp, labels.astype(np.int32), skip, t, s, smax)


@pytest.mark.parametrize("s,t", [(3, 1), (33, 20), (129, 80)])
def test_model_ties_match_jax(s, t):
    """All-zero emissions: every move ties at every cell."""
    rng = np.random.default_rng(3)
    _, labels, skip = lattice_of(s, rng)
    hold(np.zeros((t, 32), np.float32), labels, skip, t, s)


@pytest.mark.parametrize("tokens", [[5, 5, 5, 7, 7], [9] * 40])
def test_model_repeated_tokens_match_jax(tokens):
    rng = np.random.default_rng(len(tokens))
    labels, skip, need = P.lattice(np.asarray(tokens), 0)
    for t in (need, need + 9):
        hold(planted_emissions(rng, tokens, t, 32), labels, skip, t,
             len(labels))


@pytest.mark.parametrize("seed", [21, 22])
def test_model_t_equals_need_matches_jax(seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 4, 60)  # a small alphabet: repeats
    labels, skip, need = P.lattice(tokens, 0)
    hold(planted_emissions(rng, tokens.tolist(), need, 32), labels, skip,
         need, len(labels))


@pytest.mark.parametrize("s", [33, 161, 256])
def test_packed_moves_are_the_lattice_pointers(s):
    """Unpacked, the model's words are the recurrence's back-pointers of
    every state below S, step for step."""
    rng = np.random.default_rng(40 + s)
    tokens, labels, skip = lattice_of(s, rng)
    t = P.lattice(tokens, 0)[2] + 12
    lp = planted_emissions(rng, tokens, t, 32)
    _, _, words = warp_model(lp, labels, skip, t, s, s)
    want = numpy_pointers(lp, labels, skip, t, s)
    k = lanes_of(s)
    got = np.array([[move_of(w, st, k) for st in range(s)] for w in words])
    np.testing.assert_array_equal(got, want)


def test_model_reads_no_state_below_0():
    """Skip flags on states 0 and 1 change nothing: the model, like the
    kernel, allows the skip only from s >= 2."""
    rng = np.random.default_rng(50)
    tokens, labels, skip = lattice_of(65, rng)
    t = P.lattice(tokens, 0)[2] + 3
    lp = planted_emissions(rng, tokens, t, 32)
    flagged = skip.copy()
    flagged[:2] = True
    want = warp_model(lp, labels, skip, t, 65, 65)
    got = warp_model(lp, labels, flagged, t, 65, 65)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    hold(lp, labels, skip, t, 65)


def test_model_batch_equals_plain_batch():
    """A batch of mixed T and S through pack_windows: each window on the
    model at the batch's Smax equals ctc_viterbi_plain's row."""
    rng = np.random.default_rng(60)
    windows = []
    for t, n in [(40, 5), (9, 4), (90, 40), (25, 1), (130, 100)]:
        tokens = rng.integers(1, 32, n).tolist()
        need = P.lattice(np.asarray(tokens), 0)[2]
        windows.append((planted_emissions(rng, tokens, max(t, need), 32),
                        tokens))
    packed = P.pack_windows(windows)
    lp, t_len, labels, skip, s_len = packed
    want_states, want_scores = P.ctc_viterbi_plain(
        *[torch.from_numpy(x) for x in packed])
    smax = labels.shape[1]
    assert P.viterbi_geometry(len(windows), lp.shape[1], smax,
                              32)["path"] == "warp"
    for i in range(len(windows)):
        path, score, _ = warp_model(lp[i], labels[i], skip[i], t_len[i],
                                    s_len[i], smax)
        np.testing.assert_array_equal(path, want_states[i, :t_len[i]])
        assert (want_states[i, t_len[i]:] == -1).all()
        assert score == want_scores[i].item()


@pytest.mark.parametrize("smax", [33, 256])
def test_model_on_the_edge_batch(smax):
    """The lane-edge batch that chip_smoke.py and the CUDA tests give the
    kernel: each window (S up to Smax) on the model at the batch's Smax
    equals ctc_viterbi_plain's row."""
    s_values = [s for s in LANE_EDGES if s <= smax]
    packed = ctc_edge_batch(90 + smax, s_values)
    lp, t_len, labels, skip, s_len = packed
    assert labels.shape[1] == smax and s_len.tolist() == s_values
    want_states, want_scores = P.ctc_viterbi_plain(
        *[torch.from_numpy(x) for x in packed])
    for i in range(len(s_values)):
        path, score, _ = warp_model(lp[i], labels[i], skip[i], t_len[i],
                                    s_len[i], smax)
        np.testing.assert_array_equal(path, want_states[i, :t_len[i]])
        assert score == want_scores[i].item()


# ------------------------------------------------------------ dispatch


def test_track_takes_the_warp_path():
    """The smoke's track: 600 windows, Tmax 350, Smax 161, V 32: K = 6, 8
    rows a stage, 8 windows a block, bulk copies, no scratch."""
    geo = P.viterbi_geometry(600, 350, 161, 32)
    assert geo["path"] == "warp" and geo["k"] == 6 and geo["rows"] == 8
    assert geo["windows"] == 8 and geo["blocks"] == 75
    assert geo["bulk"] and geo["scratch_bytes"] == 0
    # 64 bytes of mbarriers, 4 stages of 8 rows of 32 floats, 88 groups
    # of 4 steps of 64 bytes and 368 path bytes: 27056, in 128-byte units
    assert geo["window_bytes"] == 27136 == P.window_bytes(350, 32)
    assert geo["shared_bytes"] == 8 * 27136 <= P.SHARED_MAX


@pytest.mark.parametrize("smax,path", [(256, "warp"), (257, "block"),
                                       (1025, "block")])
def test_states_pick_the_path(smax, path):
    geo = P.viterbi_geometry(3, 100, smax, 32)
    assert geo["path"] == path
    if path == "block":
        assert geo["scratch_bytes"] == 3 * 99 * smax
        assert geo["blocks"] == 3


def test_longest_tmax_on_the_warp_path():
    """The warp path holds a window while its shared bytes fit a block:
    the first Tmax past that takes the block path, at any Smax."""
    tmax = 1
    while P.window_bytes(tmax + 1, 32) <= P.SHARED_MAX:
        tmax += 1
    assert 3500 < tmax < 3700
    assert P.viterbi_geometry(4, tmax, 81, 32)["path"] == "warp"
    assert P.viterbi_geometry(4, tmax, 81, 32)["windows"] == 1
    assert P.viterbi_geometry(4, tmax + 1, 81, 32)["path"] == "block"


@pytest.mark.parametrize("v,aligned,bulk,rows", [
    (32, True, True, 8), (29, True, False, 8), (48, True, True, 4),
    (32, False, False, 8), (1000, True, True, 4), (3, True, False, 8)])
def test_ring_fill_and_rows(v, aligned, bulk, rows):
    """Bulk copies only for whole 16-byte rows on a 16-byte boundary;
    every stage offset then stays 16-byte aligned; a stage holds whole
    groups of 4 rows."""
    geo = P.viterbi_geometry(10, 200, 161, v, aligned=aligned)
    assert geo["bulk"] == bulk and geo["rows"] == rows
    assert geo["window_bytes"] % 128 == 0
    assert geo["rows"] % P.GROUP_STEPS == 0
    if bulk:
        assert (geo["rows"] * v * 4) % 16 == 0


@pytest.mark.parametrize("b,tmax,windows", [(1, 350, 8), (600, 350, 8),
                                            (600, 900, 3), (5, 2000, 1)])
def test_windows_a_block(b, tmax, windows):
    """As many windows a block as fit shared memory, at most
    WARP_MAX_WINDOWS; the blocks cover B."""
    geo = P.viterbi_geometry(b, tmax, 161, 32)
    assert geo["windows"] == windows
    assert geo["windows"] == min(P.WARP_MAX_WINDOWS,
                                 P.SHARED_MAX // P.window_bytes(tmax, 32))
    assert geo["blocks"] * windows >= b > (geo["blocks"] - 1) * windows
    assert geo["shared_bytes"] <= P.SHARED_MAX


def test_windows_a_block_bounded_by_shared_memory():
    one = P.window_bytes(2000, 32)
    geo = P.viterbi_geometry(5000, 2000, 161, 32)
    assert geo["windows"] == P.SHARED_MAX // one < P.WARP_MAX_WINDOWS


@pytest.mark.parametrize("args", [(1, 10, 1, 32), (1, 10, 4097, 32),
                                  (1, 0, 10, 32), (1, 10, 10, 0)])
def test_geometry_refuses_what_no_path_takes(args):
    with pytest.raises(ValueError):
        P.viterbi_geometry(*args)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU neither path launches: the wrapper runs the plain
    version and counts no launch."""
    rng = np.random.default_rng(70)
    windows = [(planted_emissions(rng, [3, 4], 8, 32), [3, 4])]
    packed = [torch.from_numpy(x) for x in P.pack_windows(windows)]
    before = dict(P.ctc_viterbi.path_launches), P.ctc_viterbi.launches
    got = P.ctc_viterbi(*packed)
    want = P.ctc_viterbi_plain(*packed)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (dict(P.ctc_viterbi.path_launches),
            P.ctc_viterbi.launches) == before
