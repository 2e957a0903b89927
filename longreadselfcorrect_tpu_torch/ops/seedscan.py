"""Device-side seed probing: the searchSeedsWithHybridKmers state machine.

The seed phase after the k-mer table: position attributes, the sequential
dynamic-k-mer scan (LongReadProbe.cpp:34-117), low-complexity rejection,
best-k estimation (SeedFeature.cpp:43-78) and hitchhike removal
(LongReadProbe.cpp:187-227).  The tables never leave the device; only the
per-seed records do.

Each function launches its kernel in csrc/seedscan.cu for CUDA tensors and
runs its ``*_plain`` twin for CPU tensors.  The plain versions are lockstep
transcripts of the JAX package's ops/seedscan.py; the kernels run the same
per-lane arithmetic.

Exactness: the host scan compares in float32 throughout, which both
versions reproduce bit for bit.  The one float64 in the attribute window
(ratio + 0.0005 >= 0.02, LongReadProbe.cpp:176) folds into a precomputed
f32 constant: q + a >= b on an f32 q is exact in f64 and equivalent to
q >= ceil_f32(b - a).
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda

I32 = torch.int32
F32 = torch.float32

SMAX = 128  # seed slots per read in the JAX design; the least of seed_slots


def seed_slots(L: int, start_kmer: int, offsets) -> int:
    """Seed slots per read that no read of a chunk of width L fills: a
    multiple of 32, at least SMAX.

    An emitted seed is at least start_kmer + min(offsets) long (its
    dynamic size never drops below its window's static size), lies inside
    the read, and the next window starts past its end; so a read of at
    most L symbols has at most L // that seeds, and one slot more keeps the
    automaton's overwrite of the last slot out of reach."""
    most = L // max(1, start_kmer + min(offsets)) + 1
    return max(SMAX, -(-most // 32) * 32)


def _attr_ratio_const() -> np.float32:
    """ceil_f32(f64(0.02) - f64(0.0005)) — see module docstring."""
    b = np.float64(0.02) - np.float64(0.0005)
    c = np.float32(b)
    if np.float64(c) < b:
        c = np.nextafter(c, np.float32(np.inf))
    return c


_RATIO_C = float(_attr_ratio_const())


def hh_constants(hh_ratio: float) -> tuple[float, float]:
    """(f32(hh), f32(1) / f32(hh)), the hitchhike ratio bounds."""
    hh = np.float32(hh_ratio)
    return float(hh), float(np.float32(1.0) / hh)


def _col(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[r, idx[r]] for [R, L] arr, [R] idx (clipped)."""
    return torch.gather(arr, 1, idx.clamp(0, arr.shape[1] - 1).long()[:, None])[:, 0]


def _low_complexity(counts: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """isLowComplexity of [..., 4] base counts over windows of `size`."""
    srt = torch.sort(counts, dim=-1).values
    fs = size.to(F32)
    return ((srt[..., 3].to(F32) / fs >= np.float32(0.7))
            | ((srt[..., 2] + srt[..., 3]).to(F32) / fs >= np.float32(0.9)))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(x), dtype=F32, device=like.device)


# ---------------------------------------------------------------------------
# _attributes: getSeqAttribute (LongReadProbe.cpp:120-182)
# ---------------------------------------------------------------------------

def attributes_plain(freq_scan, prefix, lens, rep_thr: float, scan_k: int):
    R, L = freq_scan.shape
    dev = freq_scan.device
    pos = torch.arange(L, dtype=I32, device=dev)
    lens2 = lens.to(I32)[:, None]
    sizes = torch.minimum(torch.tensor(scan_k, dtype=I32, device=dev), lens2 - pos)
    take = torch.minimum(pos + scan_k, lens2).clamp(0, L)
    idx_take = take.long()[..., None].expand(R, L, 4)
    idx_base = pos.long()[None, :, None].expand(R, L, 4)
    counts = torch.gather(prefix, 1, idx_take) - torch.gather(prefix, 1, idx_base)
    lowcx = _low_complexity(counts, sizes)
    eff = torch.where(lowcx, torch.full_like(freq_scan, -1), freq_scan)
    thr = _f32(rep_thr, freq_scan)
    add_garbage = eff < 0
    rem_garbage = eff <= 0
    repeat = ~add_garbage & (eff.to(F32) >= thr)
    rep_rem = ~rem_garbage & (eff.to(F32) >= thr)

    cs_add_g = torch.cumsum(add_garbage.to(I32), dim=1, dtype=I32)
    cs_rem_g = torch.cumsum(rem_garbage.to(I32), dim=1, dtype=I32)
    cs_add_r = torch.cumsum(repeat.to(I32), dim=1, dtype=I32)
    cs_rem_r = torch.cumsum(rep_rem.to(I32), dim=1, dtype=I32)

    def csum_at(cs, idx):
        v = torch.gather(cs, 1, idx.clamp(0, L - 1).long())
        return torch.where(idx < 0, torch.zeros_like(v), v)

    half = 150
    left = (pos - half).clamp(min=0)[None, :].expand(R, L)
    right = torch.minimum(pos + half, lens2 - 1)
    box_garbage = csum_at(cs_add_g, right) - csum_at(cs_rem_g, left - 1)
    box_repeat = csum_at(cs_add_r, right) - csum_at(cs_rem_r, left - 1)
    size = (right - left + 1) - box_garbage
    q = box_repeat.to(F32) / size.to(F32)
    two = torch.full_like(freq_scan, 2)
    return torch.where(q >= _f32(_RATIO_C, q), two, two - 1)


def attributes(freq_scan, prefix, lens, rep_thr: float, scan_k: int):
    """Position attribute (1 unique / 2 repeat), int32 [R, L].

    freq_scan int32 [R, L] (scan-k freq, -1 fake), prefix int32 [R, L+1, 4],
    lens int32 [R], rep_thr the f32 thresh.get(2, scan_k)."""
    if not freq_scan.is_cuda:
        return attributes_plain(freq_scan, prefix, lens, rep_thr, scan_k)
    name = "attributes"
    R, L = freq_scan.shape
    args = [cuda.check(name, freq_scan, I32, (R, L)),
            cuda.check(name, prefix, I32, (R, L + 1, 4)),
            cuda.check(name, lens, I32, (R,))]
    # each read's four flag masks and their word prefixes
    scratch = torch.empty((R, 8, -(-L // 32)), dtype=I32, device=freq_scan.device)
    out = torch.empty((R, L), dtype=I32, device=freq_scan.device)
    cuda.launch(name, "lrsc_attributes", *args, R, L, scan_k,
                float(np.float32(rep_thr)), _RATIO_C, scratch.data_ptr(),
                out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# _scan_automaton: search_seeds' nested whiles (LongReadProbe.cpp:46-104)
# ---------------------------------------------------------------------------

def scan_automaton_plain(freq, valid, attr, prefix, lens, thr_table,
                         start_kmer: int, up_bound: int, offsets: tuple,
                         hh_ratio: float, smax: int = SMAX, stats: dict | None = None):
    """Lockstep over [R] lanes, one inner-loop iteration per step; finished
    lanes idle; smax seed slots per read.  stats, if given, gets
    "lane_steps": the live lane-steps."""
    K, R, L = freq.shape
    dev = freq.device
    hh_f, inv_f = hh_constants(hh_ratio)
    hh, inv_hh = _f32(hh_f, freq), _f32(inv_f, freq)
    off_arr = torch.tensor(list(offsets), dtype=I32, device=dev)
    rlane = torch.arange(R, device=dev)
    lens = lens.to(I32)

    def fget(k, pos):
        kc = k.clamp(0, K - 1).long()
        pc = pos.clamp(0, L - 1).long()
        return freq[kc, rlane, pc], valid[kc, rlane, pc]

    def thrget(mode, size):
        return thr_table[mode.clamp(0, 2).long(), size.clamp(0, K - 1).long()]

    def where(c, a, b):
        return torch.where(c, a, b)

    ZI = torch.zeros(R, dtype=I32, device=dev)
    ZB = torch.zeros(R, dtype=torch.bool, device=dev)
    s = dict(
        init_pos=ZI, stat=ZI, dyn_mode=ZI, seed_pos=ZI, dyn_size=ZI,
        is_seed=ZB, is_repeat=ZB, max_fixed=ZI, next_init=ZI, curr=ZI,
        inner=ZB, done=lens < start_kmer, n=ZI,
        starts=torch.zeros((R, smax), dtype=I32, device=dev),
        sizes=torch.zeros((R, smax), dtype=I32, device=dev),
        freqs=torch.zeros((R, smax), dtype=I32, device=dev),
        reps=torch.zeros((R, smax), dtype=torch.bool, device=dev),
        statics=torch.zeros((R, smax), dtype=I32, device=dev),
    )
    slots = torch.arange(smax, dtype=I32, device=dev)[None, :]
    lane_steps = 0
    while bool((~s["done"]).any()):
        live = ~s["done"]
        if stats is not None:
            lane_steps += int(live.sum())
        # ---- outer init for lanes entering a new window -------------------
        start_outer = live & ~s["inner"]
        ip = s["init_pos"]
        dmode = _col(attr, ip)
        stat0 = start_kmer + off_arr[dmode.clamp(0, 2).long()]
        fits0 = ip + stat0 <= lens
        mf0, _ = fget(stat0, ip)

        stat = where(start_outer, stat0, s["stat"])
        dyn_mode = where(start_outer, dmode, s["dyn_mode"])
        seed_pos = where(start_outer, ip, s["seed_pos"])
        dyn_size = where(start_outer, stat0, s["dyn_size"])
        is_seed = where(start_outer, ZB, s["is_seed"])
        is_rep = where(start_outer, ZB, s["is_repeat"])
        max_fixed = where(start_outer, where(fits0, mf0, ZI - 1), s["max_fixed"])
        next_init = where(start_outer, ip, s["next_init"])
        curr = where(start_outer, ip, s["curr"])

        # ---- one inner-loop iteration --------------------------------------
        inner = live
        in_range = curr < lens
        static_fake = curr + stat > lens
        exit_now = inner & (~in_range | static_fake)

        work = inner & ~exit_now
        static_mode = _col(attr, curr)
        dyn_size = where(work & is_seed, dyn_size + 1, dyn_size)
        dyn_fake = seed_pos + dyn_size > lens
        dfreq, dvalid = fget(dyn_size, seed_pos)
        dyn_freq = where(dyn_fake, ZI - 1, dfreq)
        dyn_valid = where(dyn_fake, ZB, dvalid)
        sfreq, _ = fget(stat, curr)
        dyn_thr = thrget(dyn_mode, dyn_size)
        stat_thr = thrget(static_mode, stat)
        rep_thr = (_f32(5.0, freq) - ((static_mode >> 1) << 2).to(F32)) * stat_thr

        fail = ((sfreq.to(F32) < stat_thr) | (dyn_freq.to(F32) < dyn_thr)
                | ~dyn_valid | (dyn_size > up_bound))
        fd = sfreq.to(F32) / max_fixed.to(F32)
        low = ~fail & (fd < hh)
        high = ~fail & ~low & (fd > inv_hh)
        go = work & ~fail & ~low & ~high
        exit_fail = work & fail
        exit_low = work & low
        exit_high = work & high

        dyn_size = where(exit_fail & is_seed, dyn_size - 1, dyn_size)
        dyn_size = where(exit_low, dyn_size - 1, dyn_size)
        next_init = where(exit_low, next_init + 1, next_init)
        next_init = where(exit_high, curr - 1, next_init)
        next_init = where(go, seed_pos + dyn_size - 1, next_init)
        is_seed = where(exit_high, ZB, is_seed)
        is_seed = where(go, ~ZB, is_seed)
        is_rep = is_rep | (go & (sfreq.to(F32) >= rep_thr))
        max_fixed = where(go, torch.maximum(max_fixed, sfreq), max_fixed)
        curr = where(go, curr + 1, curr)

        exiting = exit_now | exit_fail | exit_low | exit_high

        # ---- on exit: low-complexity check + emission ---------------------
        hi_i = (seed_pos + dyn_size).clamp(0, L).long()[:, None, None].expand(R, 1, 4)
        lo_i = seed_pos.clamp(0, L).long()[:, None, None].expand(R, 1, 4)
        wc = (torch.gather(prefix, 1, hi_i) - torch.gather(prefix, 1, lo_i))[:, 0]
        lowcx = _low_complexity(wc, dyn_size)
        emit = exiting & is_seed & ~lowcx

        slot = s["n"].clamp(0, smax - 1)
        wsel = (slots == slot[:, None]) & emit[:, None]
        starts = where(wsel, seed_pos[:, None], s["starts"])
        sizes = where(wsel, dyn_size[:, None], s["sizes"])
        freqs = where(wsel, max_fixed[:, None], s["freqs"])
        reps = where(wsel, is_rep[:, None], s["reps"])
        statics = where(wsel, stat[:, None], s["statics"])
        n = where(emit & (s["n"] < smax), s["n"] + 1, s["n"])

        init_pos = where(exiting, next_init + 1, s["init_pos"])
        done = s["done"] | (exiting & (init_pos >= lens))
        s = dict(
            init_pos=init_pos, stat=stat, dyn_mode=dyn_mode,
            seed_pos=seed_pos, dyn_size=dyn_size, is_seed=is_seed,
            is_repeat=is_rep, max_fixed=max_fixed, next_init=next_init,
            curr=curr, inner=live & ~exiting, done=done,
            n=n, starts=starts, sizes=sizes, freqs=freqs, reps=reps,
            statics=statics,
        )
    if stats is not None:
        stats["lane_steps"] = stats.get("lane_steps", 0) + lane_steps
    return s["n"], s["starts"], s["sizes"], s["freqs"], s["reps"], s["statics"]


def scan_automaton_args(freq, valid, attr, prefix, lens, thr_table, start_kmer: int,
                        up_bound: int, offsets: tuple, hh_ratio: float, outs,
                        rounds: torch.Tensor | None = None, on_card: bool = True) -> list:
    """lrsc_scan_automaton's arguments, the stream aside; outs: the six
    output tensors, whose width is the slot count.  on_card=False takes CPU tensors (the kernel compiled
    for the host, in the tests)."""
    name = "scan_automaton"
    K, R, L = freq.shape
    off = [int(o) for o in offsets]
    if len(off) != 3:
        raise ValueError(f"{name}: expected 3 offsets, got {off}")
    ins = [cuda.check(name, freq, I32, (K, R, L), on_card),
           cuda.check(name, valid, torch.bool, (K, R, L), on_card),
           cuda.check(name, attr, I32, (R, L), on_card),
           cuda.check(name, prefix, I32, (R, L + 1, 4), on_card),
           cuda.check(name, lens, I32, (R,), on_card),
           cuda.check(name, thr_table, F32, (3, K), on_card)]
    n, starts, sizes, freqs, reps, statics = outs
    smax = starts.shape[1]
    hh, inv_hh = hh_constants(hh_ratio)
    return ins + [K, R, L, start_kmer, up_bound, *off, hh, inv_hh, smax,
                  cuda.check(name, n, I32, (R,), on_card),
                  *(cuda.check(name, t, I32, (R, smax), on_card)
                    for t in (starts, sizes, freqs)),
                  cuda.check(name, reps, torch.bool, (R, smax), on_card),
                  cuda.check(name, statics, I32, (R, smax), on_card),
                  None if rounds is None else cuda.check(name, rounds, I32, (R,), on_card)]


def scan_automaton_outputs(R: int, device, smax: int = SMAX) -> tuple:
    """Empty (n, starts, sizes, freqs, reps, statics) for R reads of smax
    seed slots."""
    n = torch.empty(R, dtype=I32, device=device)
    starts, sizes, freqs, statics = (
        torch.empty((R, smax), dtype=I32, device=device) for _ in range(4))
    reps = torch.empty((R, smax), dtype=torch.bool, device=device)
    return n, starts, sizes, freqs, reps, statics


def scan_automaton(freq, valid, attr, prefix, lens, thr_table, start_kmer: int,
                   up_bound: int, offsets: tuple, hh_ratio: float, smax: int = SMAX,
                   rounds: torch.Tensor | None = None):
    """SoA seed records (n [R], starts, sizes, freqs [R, smax] int32,
    reps [R, smax] bool, statics [R, smax] int32).

    freq int32 [K, R, L], valid bool [K, R, L], attr int32 [R, L],
    prefix int32 [R, L+1, 4], lens int32 [R], thr_table f32 [3, K].
    smax: seed slots per read; once a read's are full, each further seed
    overwrites the last (the JAX design at SMAX).
    rounds, an int32 [R] CUDA tensor if given, receives each read's
    dependent rounds in the kernel: one per window it ran and one per
    round of 32 speculative steps."""
    if not freq.is_cuda:
        return scan_automaton_plain(freq, valid, attr, prefix, lens, thr_table,
                                    start_kmer, up_bound, offsets, hh_ratio, smax)
    outs = scan_automaton_outputs(freq.shape[1], freq.device, smax)
    cuda.launch("scan_automaton", "lrsc_scan_automaton", *scan_automaton_args(
        freq, valid, attr, prefix, lens, thr_table, start_kmer, up_bound, offsets,
        hh_ratio, outs, rounds))
    return outs


# ---------------------------------------------------------------------------
# _estimate_best: estimateBestKmerSize (SeedFeature.cpp:43-78)
# ---------------------------------------------------------------------------

def estimate_best_plain(freq, n, starts, sizes, statics, pb_coverage: int,
                        stats: dict | None = None):
    """stats, if given, gets "walk_steps": the lane-steps of both walks,
    and "pole_steps": int32 [2, R, S], the k steps each slot's start (0)
    and end (1) pole took."""
    K, R, L = freq.shape
    dev = freq.device
    upper = pb_coverage >> 1
    lower = pb_coverage >> 2
    rl = torch.arange(R, device=dev)[:, None]
    valid_seed = torch.arange(starts.shape[1], dtype=I32, device=dev)[None, :] < n[:, None]
    one = torch.ones_like(starts)

    def bfreq(k, pole_start):
        kc = k.clamp(1, K - 1).long()
        pos = starts if pole_start else starts + sizes - k
        pc = pos.clamp(0, L - 1).long()
        return freq[kc, rl, pc], (k >= K) | (k < 1)

    def walk(pole_start):
        k = statics
        kf, oor0 = bfreq(k, pole_start)
        up = kf > upper
        down = kf < lower
        bit = torch.where(up, one, torch.where(down, -one, 0 * one))
        active = valid_seed & (bit != 0)
        freq_bound = torch.where(bit > 0, upper * one, lower * one)
        cors_bound = torch.where(bit > 0, lower * one, upper * one)
        size_bound = torch.where(bit > 0, sizes, statics)
        oor = oor0 & active
        steps = 0
        taken = torch.zeros_like(starts)
        while bool(active.any()):
            steps += int(active.sum()) if stats is not None else 0
            go = active & ((bit ^ kf) > (bit ^ freq_bound)) & (
                (bit ^ k) < (bit ^ size_bound))
            k2 = torch.where(go, k + bit, k)
            kf2, o2 = bfreq(k2, pole_start)
            kf = torch.where(go, kf2, kf)
            oor = oor | (go & o2)
            k = k2
            taken += go.to(I32)
            active = active & go
        back = valid_seed & (bit != 0) & ((bit ^ kf) < (bit ^ cors_bound))
        return torch.where(back, k - bit, k), oor, steps, taken

    sk, oor1, st1, t1 = walk(True)
    ek, oor2, st2, t2 = walk(False)
    if stats is not None:
        stats["walk_steps"] = stats.get("walk_steps", 0) + st1 + st2
        stats["pole_steps"] = torch.stack([t1, t2])
    return sk, ek, oor1 | oor2


def estimate_best(freq, n, starts, sizes, statics, pb_coverage: int):
    """(start_k, end_k int32 [R, S], out_of_range bool [R, S]) for the
    S = starts.shape[1] seed slots; out_of_range lanes walked past the
    table and need a host redo."""
    if not freq.is_cuda:
        return estimate_best_plain(freq, n, starts, sizes, statics, pb_coverage)
    name = "estimate_best"
    K, R, L = freq.shape
    S = starts.shape[1]
    args = [cuda.check(name, freq, I32, (K, R, L)),
            cuda.check(name, n, I32, (R,)),
            cuda.check(name, starts, I32, (R, S)),
            cuda.check(name, sizes, I32, (R, S)),
            cuda.check(name, statics, I32, (R, S))]
    dev = freq.device
    sk = torch.empty((R, S), dtype=I32, device=dev)
    ek = torch.empty((R, S), dtype=I32, device=dev)
    oor = torch.empty((R, S), dtype=torch.bool, device=dev)
    cuda.launch(name, "lrsc_estimate_best", *args, K, R, L, S, int(pb_coverage),
                sk.data_ptr(), ek.data_ptr(), oor.data_ptr())
    return sk, ek, oor


# ---------------------------------------------------------------------------
# _remove_hitchhiking: removeHitchhikingSeeds (LongReadProbe.cpp:187-227)
# ---------------------------------------------------------------------------

def remove_hitchhiking_plain(n, starts, sizes, freqs, reps, radius: int,
                             hh_ratio: float):
    """The host loops qi<si with an early break when the gap exceeds the
    radius; starts ascend, so the break equals the window mask.  The
    [R, S, S] pair masks are built a few reads at a time."""
    R, S = starts.shape
    step = max(1, (1 << 22) // (S * S))
    if R > step:
        return torch.cat([remove_hitchhiking_plain(
            n[i : i + step], starts[i : i + step], sizes[i : i + step],
            freqs[i : i + step], reps[i : i + step], radius, hh_ratio)
            for i in range(0, R, step)])
    dev = starts.device
    ends = starts + sizes - 1
    valid = torch.arange(S, dtype=I32, device=dev)[None, :] < n[:, None]
    q_end = ends[:, :, None]
    s_start = starts[:, None, :]
    iq = torch.arange(S, device=dev)[None, :, None]
    is_ = torch.arange(S, device=dev)[None, None, :]
    pair = (is_ > iq) & valid[:, :, None] & valid[:, None, :] & (
        s_start - q_end <= radius)
    fd = freqs[:, None, :].to(F32) / freqs[:, :, None].to(F32)
    hh_f, inv_f = hh_constants(hh_ratio)
    # query q repeat & fd<hh -> SUBJECT s hitchhiked; subject s repeat &
    # fd>1/hh -> QUERY q hitchhiked (axes: 1 = q, 2 = s)
    subj_hit = pair & reps[:, :, None] & (fd < _f32(hh_f, fd))
    query_hit = pair & reps[:, None, :] & (fd > _f32(inv_f, fd))
    hitch = subj_hit.any(dim=1) | query_hit.any(dim=2)
    return valid & ~hitch


def remove_hitchhiking(n, starts, sizes, freqs, reps, radius: int, hh_ratio: float):
    """keep bool [R, S]: valid seed slots (of S = starts.shape[1]) that no
    repeat seed hitchhikes."""
    if not starts.is_cuda:
        return remove_hitchhiking_plain(n, starts, sizes, freqs, reps, radius,
                                        hh_ratio)
    name = "remove_hitchhiking"
    R, S = starts.shape
    args = [cuda.check(name, n, I32, (R,)),
            cuda.check(name, starts, I32, (R, S)),
            cuda.check(name, sizes, I32, (R, S)),
            cuda.check(name, freqs, I32, (R, S)),
            cuda.check(name, reps, torch.bool, (R, S))]
    keep = torch.empty((R, S), dtype=torch.bool, device=starts.device)
    hh, inv_hh = hh_constants(hh_ratio)
    cuda.launch(name, "lrsc_remove_hitchhiking", *args, R, S, int(radius), hh, inv_hh,
                keep.data_ptr())
    return keep
