"""Plant faults in copies of the flash-attention kernels (K3, K4), bf16
and f32, and show which of chip_smoke.py's gates fail each one; the sound
source must pass them all.

Each fault is one text edit of ``singa_tpu_torch/csrc/flash_attention.cu``.
The edited copies are written and built (one ``nvcc`` each, all started
together) under a temporary directory, never in the package, and each is
loaded in place of the sound library in turn. Every copy then runs
chip_smoke.py's flash cases in the dtype of its fault at the LM shape (B8
H8 S1024 D64, causal and not), the ragged case, the narrow-load case
(D=30) and the ``pos_delta`` case, read at both gates: FLASH_TOL (scaled
by the largest reference value of the tensor) and FLASH_ELEM_TOL (per
element). Each copy with a bf16 fault also runs the bf16 LM training
steps of chip_smoke.py, held to the plain-attention run at
LM_BF16_LOSS_TOL and LM_BF16_UPDATE_TOL. The sound library's readings are
printed for both dtypes, at chip_smoke.py's cases and at the shapes of
``tests/test_torch_cuda_kernels.py``: the per-element limits are set from
them. Needs one CUDA card; exits 1 if the sound source fails a gate or a
fault passes every gate:

    python3 flash_gate_check.py     # also writes chiprun_out/flash_gate_check.json

With ``--alternatives`` it checks no gate: it builds the design
alternatives of the f32 kernels in ``ALTERNATIVES`` the same way and
times each against the sound kernels at the LM shape, causal and not, in
turns (device time of the kernel, ``torch.profiler``):

    python3 flash_gate_check.py --alternatives  # flash_alternatives.json
"""

import json
import os
import subprocess
import sys
import tempfile

import chip_smoke as cs

# name: (what the fault does, the text it replaces, its replacement), in
# the bf16 (tensor-core) kernels
FAULTS = {
    "fwd_no_rescale_last_tile": (
        "K3 skips the alpha rescale of its output sums at the last k tile",
        "    for (int n = 0; n < NT; ++n) {\n      acc[n][0] *= alpha[0];",
        "    for (int n = 0; n < (kt + 1 < kend ? NT : 0); ++n) {\n"
        "      acc[n][0] *= alpha[0];"),
    "fwd_drop_last_k_tile": (
        "K3 leaves out the last k tile where no causal bound applies",
        "(causal && !has_delta) ? min(nkb, (q0 + BM - 1) / BN + 1) : nkb;",
        "(causal && !has_delta) ? min(nkb, (q0 + BM - 1) / BN + 1) : "
        "nkb - 1;"),
    "dq_drop_last_k_tile": (
        "K4-dQ leaves out the last k tile where no causal bound applies",
        "const int kend = causal ? min(nkb, (q0 + BM - 1) / BN + 1) : nkb;",
        "const int kend = causal ? min(nkb, (q0 + BM - 1) / BN + 1) : "
        "nkb - 1;"),
    "dq_no_delta": (
        "K4-dQ leaves delta out of dS",
        "s[j][e] = p * (dp[j][e] - delta_r[r]) * scale;  // dS",
        "s[j][e] = p * dp[j][e] * scale;  // dS"),
    "dkv_zero_last_k_tile": (
        "K4-dKV writes zeros for the last k/v tile",
        "const int qstart = causal ? k0 / BQ : 0;",
        "const int qstart = k0 + BKV >= Sk ? nqb : causal ? k0 / BQ : 0;"),
    "dkv_drop_last_q_tile": (
        "K4-dKV leaves out the last q tile",
        "  for (int qt = qstart; qt < nqb; ++qt) {\n"
        "    const int st = (qt - qstart) & 1;",
        "  for (int qt = qstart; qt < nqb - 1; ++qt) {\n"
        "    const int st = (qt - qstart) & 1;"),
    "fwd_late_rows_10pct": (
        "K3 writes the later half of the rows of out 10% small",
        "inv[r] = 1.f / ls;",
        "inv[r] = (rows[r] >= Sq / 2 ? 0.9f : 1.f) / ls;"),
    "dkv_last_tile_10pct": (
        "K4-dKV writes dK and dV of the last k/v tile 10% small",
        "  const float one[2] = {1.f, 1.f};\n  store_rows<NW>(dk",
        "  const float one[2] = {k0 + BKV >= Sk ? 0.9f : 1.f,\n"
        "                        k0 + BKV >= Sk ? 0.9f : 1.f};\n"
        "  store_rows<NW>(dk"),
    "dkv_zero": (
        "K4-dKV writes zeros for every tile",
        "const int qstart = causal ? k0 / BQ : 0;",
        "const int qstart = nqb;"),
}

# the same, in the f32 (CUDA-core) kernels
F32_FAULTS = {
    "fwd_f32_no_rescale_last_tile": (
        "K3 f32 skips the alpha rescale of its output sums at the last k "
        "tile",
        "      for (int h = 0; h < NH; ++h) {\n        acc[i][h].x *= alpha;",
        "      for (int h = 0; h < (kt + 1 < kt_end ? NH : 0); ++h) {\n"
        "        acc[i][h].x *= alpha;"),
    "fwd_f32_drop_last_k_tile": (
        "K3 f32 leaves out the last k tile where no causal bound applies",
        "causal && !has_delta ? min(nkt, (q0 + BM - 1) / BN + 1) : nkt;",
        "causal && !has_delta ? min(nkt, (q0 + BM - 1) / BN + 1) : nkt - 1;"),
    "fwd_f32_stage_one_tile_late": (
        "K3 f32 reads V from the other stage of its double buffer (the "
        "previous tile's, or the next one's while it arrives) after the "
        "first tile",
        "const float* tV = sV + st * BN * LD;\n    const int k0 = kt * BN;\n\n"
        "    float s[4][NJ];",
        "const float* tV = sV + (kt ? st ^ 1 : st) * BN * LD;\n"
        "    const int k0 = kt * BN;\n\n    float s[4][NJ];"),
    "dq_f32_no_delta": (
        "K4-dQ f32 leaves delta out of dS",
        "sw[4 * i * LP + lc + 8 * j] = p * (dp[i][j] - delta_r[i]) * scale;",
        "sw[4 * i * LP + lc + 8 * j] = p * dp[i][j] * scale;"),
    "dkv_f32_last_tile_10pct": (
        "K4-dKV f32 writes dK and dV of the last k/v tile 10% small",
        "  const float unit[4] = {1.f, 1.f, 1.f, 1.f};\n  store_f32<NW>(dk",
        "  const float tenth = k0 + BKV >= Sk ? 1.f / 0.9f : 1.f;\n"
        "  const float unit[4] = {tenth, tenth, tenth, tenth};\n"
        "  store_f32<NW>(dk"),
    "f32_4byte_path_off_by_one": (
        "the f32 4-byte load path (D % 4 != 0 or an unaligned row) reads "
        "each value from the next column",
        "ok ? src + (long long)(row0 + r) * D + d : src, ok ? 4 : 0);",
        "ok && d + 1 < D ? src + (long long)(row0 + r) * D + d + 1 : src,\n"
        "                ok && d + 1 < D ? 4 : 0);"),
}

_K3_PV = ("    mul_acc<BN, NH, DMAX>(acc, pw, tV + 4 * lc, 0, D);  "
          "// acc += P V\n")
_K3_SCORES = ("    scores<NJ, DMAX>(s, sQ + wr * LD, tK + lc * LD, D);  "
              "// Q K^T\n")
_K3_NO_SCORES = ("    for (int i = 0; i < 4; ++i)\n"
                 "      for (int j = 0; j < NJ; ++j) s[i][j] = tK[lc * LD + j];"
                 "\n")
_DKV_PREFETCH = """    if (qt + 1 < nqt) {
      const int nq0 = (qt + 1) * BQ;
      load_tile_f32<BQ, DMAX>(sQ + (st ^ 1) * BQ * LD, qb, nq0, Sq, D, vec);
      load_tile_f32<BQ, DMAX>(sG + (st ^ 1) * BQ * LD, gb, nq0, Sq, D, vec);
      load_rows<BQ>(sL + (st ^ 1) * BQ, lb, nq0, Sq);
      load_rows<BQ>(sD + (st ^ 1) * BQ, db, nq0, Sq);
      cp_async_commit();
    }
"""
_DKV_LAST = ("    mul_acc<BQ, NW, DMAX>(dk_acc, dsw, tQ + c0 + 4 * lc, c0, D);  "
             "// dS^T Q\n")
# dK/dV with Q, dO, lse and delta in one stage, reloaded after a barrier
_DKV_ONE_STAGE = [
    (_DKV_PREFETCH, ""),
    ("const int st = (qt - qt0) & 1;", "const int st = 0;"),
    ("float* sG = sQ + 2 * BQ * LD;", "float* sG = sQ + BQ * LD;"),
    ("float* sPt = sG + 2 * BQ * LD;", "float* sPt = sG + BQ * LD;"),
    (_DKV_LAST, _DKV_LAST + "    __syncthreads();\n"
     + _DKV_PREFETCH.replace(" + (st ^ 1) * BQ * LD", "")
     .replace(" + (st ^ 1) * BQ", "")),
    ("((2 * C::BKV + 4 * C::BQ) * C::LD +",
     "((2 * C::BKV + 2 * C::BQ) * C::LD +"),
]

# design alternatives, timed against the sound kernels with --alternatives:
# name: (what it changes, [(text, replacement), ...]); the first three take
# work out of K3 to show where its time goes (their outputs are wrong)
ALTERNATIVES = {
    "k3_no_pv": ("K3 without its P V loop", [(_K3_PV, "")]),
    "k3_no_scores": ("K3 without its score loop",
                     [(_K3_SCORES, _K3_NO_SCORES)]),
    "k3_no_loops": ("K3 with neither loop: copies, softmax, barriers and "
                    "stores", [(_K3_PV, ""), (_K3_SCORES, _K3_NO_SCORES)]),
    "exp2f": ("the softmax of K3, K4-dQ and K4-dKV in exp2f of "
              "log2e-scaled arguments, as the bf16 kernels, not expf", [
                  ("ok[j] ? expf(s[i][j] - m_new) : 0.f;",
                   "ok[j] ? exp2f((s[i][j] - m_new) * kLog2e) : 0.f;"),
                  ("const float alpha = expf(m[i] - m_new);",
                   "const float alpha = exp2f((m[i] - m_new) * kLog2e);"),
                  ("ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;",
                   "ok ? exp2f((s[i][j] * scale - lse_r[i]) * kLog2e) : 0.f;"),
                  ("ok ? expf(s[i][j] * scale - tL[qc]) : 0.f;",
                   "ok ? exp2f((s[i][j] * scale - tL[qc]) * kLog2e) : 0.f;")]),
    "unroll_full": ("every d and key loop unrolled in full, not by 4",
                    [("#pragma unroll 4\n", "#pragma unroll\n")]),
    "k3_bn32": ("K3 k tiles of 32 keys at DMAX 64 (3 blocks per SM)",
                [("static constexpr int BN = DMAX == 64 ? 64 : 32;",
                  "static constexpr int BN = 32;")]),
    "dkv_one_stage": ("dKV with Q, dO, lse and delta in one stage (3 "
                      "blocks per SM)", _DKV_ONE_STAGE),
    "dkv_one_stage_bq64": ("dKV with one stage of 64-row q tiles (4 x 8 "
                           "score tiles, 2 blocks per SM)", _DKV_ONE_STAGE + [
                               ("static constexpr int BQ = 32;",
                                "static constexpr int BQ = "
                                "DMAX == 64 ? 64 : 32;")]),
}

# the shapes of tests/test_torch_cuda_kernels.py (B2 H3, seed 0)
TEST_SHAPES = [(128, 128, 64), (72, 72, 16), (100, 100, 100), (40, 130, 130),
               (130, 40, 32), (64, 64, 256)]


def build_copies(edits, workdir):
    """``{name: library}``, each built from a copy of the source edited by
    ``edits[name]``, a list of ``(text, replacement)``: each text must be
    found in the source, a fault's once."""
    from singa_tpu_torch import cuda_build
    src = (cuda_build.CSRC_DIR / "flash_attention.cu").read_text()
    procs = {}
    for name, pairs in edits.items():
        text = src
        for old, new in pairs:
            n = text.count(old)
            cs.check(n == 1 or (n > 1 and name in ALTERNATIVES),
                     f"{name}: its text is found {n} times in the source")
            text = text.replace(old, new)
        cu = os.path.join(workdir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(workdir, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"{name} did not build:\n{log}")
        libs[name] = so
    return libs


def build_faults(workdir):
    """Each fault's library, built from an edited copy of the source."""
    return build_copies({name: [(old, new)] for name, (_, old, new)
                         in {**FAULTS, **F32_FAULTS}.items()}, workdir)


def time_alternatives(dev, workdir):
    """K3, K4-dQ and K4-dKV f32 at the LM shape, causal and not: device
    ms of the sound build and of each alternative, in turns (sound,
    alternative, alternative, sound)."""
    import statistics
    import torch
    from singa_tpu_torch import cuda_build
    from singa_tpu_torch.ops import attention as at
    libs = build_copies({n: e for n, (_, e) in ALTERNATIVES.items()},
                        workdir)
    sound = str(cuda_build.library_path("flash_attention"))
    B, H, S = cs.LM["batch"], cs.LM["heads"], cs.LM["seq"]
    D = cs.LM["d_model"] // cs.LM["heads"]
    names = cs.FLASH_KERNEL_NAME["float32"]
    out = {}
    for causal in (True, False):
        _, inputs = cs.flash_run(dev, B, H, S, S, D, torch.float32, causal)
        q, k, v, g, o, lse, scale = inputs
        delta = (g * o).sum(-1)
        calls = {
            "flash_fwd": lambda: at.flash_fwd(q, k, v, causal, scale),
            "flash_bwd_dq": lambda: at.flash_bwd_dq(q, k, v, g, lse, delta,
                                                    causal, scale),
            "flash_bwd_dkv": lambda: at.flash_bwd_dkv(q, k, v, g, lse, delta,
                                                      causal, scale)}
        for name, so in libs.items():
            rec = {}
            for kind, fn in calls.items():
                r = {"sound": [], "alternative": []}
                for which in ("sound", "alternative", "alternative",
                              "sound"):
                    use_library(sound if which == "sound" else so)
                    r[which].append(cs.device_ms(fn, names[kind]))
                rec[kind] = {w: statistics.mean(x) for w, x in r.items()}
            use_library(sound)
            out.setdefault(name, {})["causal" if causal else "full"] = rec
            print(f"alternative {name} ({ALTERNATIVES[name][0]}), "
                  f"{'causal' if causal else 'not causal'}, device ms "
                  "sound -> alternative: " + "; ".join(
                      f"{kind} {r['sound']:.4f} -> {r['alternative']:.4f}"
                      for kind, r in rec.items()), flush=True)
    return out


def use_library(path):
    """Load ``path`` in place of the flash-attention library."""
    import ctypes
    from singa_tpu_torch import cuda_build
    cuda_build._libs["flash_attention"] = ctypes.CDLL(path)


def smoke_cases(dtypes):
    """chip_smoke.py's flash cases (flash_kernel_phase) in ``dtypes``."""
    B, H, S = cs.LM["batch"], cs.LM["heads"], cs.LM["seq"]
    D = cs.LM["d_model"] // cs.LM["heads"]
    for dtype in dtypes:
        for causal in (True, False):
            yield (B, H, S, S, D, dtype, causal, None, 0)
        yield (2, 4, 1000, 1000, 32, dtype, True, None, 1)
        yield (2, 4, 333, 333, 30, dtype, True, None, 3)
        yield (B, H, S, S, D, dtype, True, -300, 2)


def case_readings(dev, case):
    B, H, Sq, Sk, D, dtype, causal, pos_delta, seed = case
    name = str(dtype).split(".")[-1]
    got, _ = cs.flash_run(dev, B, H, Sq, Sk, D, dtype, causal, pos_delta,
                          seed)
    errs, elem, failed = cs.flash_readings(got, name)
    label = (f"B{B} H{H} Sq{Sq} Sk{Sk} D{D} {name} causal={causal} "
             f"pos_delta={pos_delta}")
    return {"case": label, "max_abs_err": errs, "elem_err": elem,
            "fails_max_gate": [m for g, m in failed if g == "FLASH_TOL"],
            "fails_elem_gate": [m for g, m in failed
                                if g == "FLASH_ELEM_TOL"]}


def describe(c):
    """One case's readings and verdicts, as printed."""
    return (f"{c['case']}: max_abs_err "
            + " ".join(f"{w}={e:.3g}" for w, e in c["max_abs_err"].items())
            + "; per element "
            + " ".join(f"{w}={e:.3g}" for w, e in c["elem_err"].items())
            + f" -> FLASH_TOL {'FAILS' if c['fails_max_gate'] else 'passes'}"
            f", FLASH_ELEM_TOL "
            f"{'FAILS' if c['fails_elem_gate'] else 'passes'}")


def card_test_readings(dev):
    """The sound kernels' per-element readings at the card tests' shapes."""
    import torch
    from singa_tpu_torch.ops import attention as at
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        worst = 0.0
        for Sq, Sk, D in TEST_SHAPES:
            for causal in (False, True):
                gen = torch.Generator(device="cuda")
                gen.manual_seed(0)
                q, k, v, g = [torch.randn(2, 3, S, D, generator=gen,
                                          device="cuda").to(dtype)
                              for S in (Sq, Sk, Sk, Sq)]
                scale = D ** -0.5
                o, lse = at.flash_fwd(q, k, v, causal, scale)
                got = (o,) + at.flash_bwd(q, k, v, o, lse, g, causal, scale)
                want = (at._scan_flash_fwd(q, k, v, causal, scale)[0],) + \
                    at._scan_flash_bwd(q, k, v, o, lse, g, causal, scale)
                worst = max([worst] + [cs.elem_err(a, b)
                                       for a, b in zip(got, want)])
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        q, k, v = [torch.randn(1, 2, 96, 32, generator=gen,
                               device="cuda").to(dtype) for _ in range(3)]
        for delta in (-40, 0, 24):
            o = at.flash_fwd(q, k, v, True, 0.2, pos_delta=delta)[0]
            ro = at._scan_flash_fwd(q, k, v, True, 0.2, pos_delta=delta)[0]
            worst = max(worst, cs.elem_err(o, ro))
        out[name] = worst
        print(f"sound {name} at the card tests' shapes: per-element reading "
              f"max {worst:.4g} (tolerance {cs.FLASH_ELEM_TOL[name]})",
              flush=True)
    return out


def lm_runs(dev):
    """The bf16 LM steps with the plain attention, once; returns a function
    that runs them through the loaded kernels and reads the gates."""
    import torch
    from singa_tpu_torch.ops import attention as at
    tx, ty = cs.lm_data(dev)
    start = cs.lm_states(cs.lm_model(dev, tx, train=False), cs.SEED + 4)
    mb = cs.lm_model(dev, tx, torch.bfloat16)
    at.USE_PLAIN = True
    try:
        p_losses = cs.lm_train_run(mb, start, tx, ty, cs.LM_BF16_STEPS)[0]
    finally:
        at.USE_PLAIN = False
    plain = {k: v.data.detach().clone() for k, v in mb.get_params().items()}

    def run():
        losses = cs.lm_train_run(mb, start, tx, ty, cs.LM_BF16_STEPS)[0]
        after = {k: v.data.detach().clone()
                 for k, v in mb.get_params().items()}
        r, failed = cs.lm_bf16_readings(losses, p_losses, after, plain,
                                        start)
        return dict(r, losses=losses, plain_losses=p_losses, failed=failed)
    return run


def main():
    import torch
    if not torch.cuda.is_available():
        print("flash_gate_check: no CUDA device is available",
              file=sys.stderr)
        return 2
    from singa_tpu_torch import cuda_build, device
    print(f"card: {cs.card_line()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build()
    dev = device.create_cuda_gpu(0)
    out_dir = os.path.join(cs.HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    if "--alternatives" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as work:
            alts = time_alternatives(dev, work)
        with open(os.path.join(out_dir, "flash_alternatives.json"), "w") as f:
            json.dump(alts, f, indent=1)
        return 0
    sound_lib = str(cuda_build.library_path("flash_attention"))
    with tempfile.TemporaryDirectory() as work:
        libs = build_faults(work)
        lm = lm_runs(dev)
        record, bad = {"tolerances": {
            "FLASH_TOL": cs.FLASH_TOL, "FLASH_ELEM_TOL": cs.FLASH_ELEM_TOL,
            "LM_BF16_LOSS_TOL": cs.LM_BF16_LOSS_TOL,
            "LM_BF16_UPDATE_TOL": cs.LM_BF16_UPDATE_TOL,
            "LM_BF16_UPDATE_FLOOR": cs.LM_BF16_UPDATE_FLOOR}}, []
        use_library(sound_lib)
        cases = [case_readings(dev, c) for c in
                 smoke_cases((torch.float32, torch.bfloat16))]
        record["sound"] = {"cases": cases,
                           "test_shapes": card_test_readings(dev)}
        record["sound"]["lm"] = lm()
        for c in cases:
            print(f"sound {describe(c)}", flush=True)
            if c["fails_max_gate"] or c["fails_elem_gate"]:
                bad.append(f"sound {c['case']}")
        s_lm = record["sound"]["lm"]
        print(f"sound LM bf16: final loss rel {s_lm['final_loss_rel']:.3g} "
              f"decrease rel {s_lm['decrease_rel']:.3g} (decrease "
              f"{s_lm['decrease']:.5f} against {s_lm['plain_decrease']:.5f})"
              f" updates rel max {s_lm['update_rel_max']:.3g} "
              f"({s_lm['update_rel_at']})", flush=True)
        if s_lm["failed"]:
            bad.append("sound LM")
        record["faults"] = {}
        for name, so in libs.items():
            use_library(so)
            bf16 = name in FAULTS
            what = (FAULTS if bf16 else F32_FAULTS)[name][0]
            fc = [case_readings(dev, c) for c in
                  smoke_cases((torch.bfloat16 if bf16 else torch.float32,))]
            f_lm = lm() if bf16 else None
            caught = {"FLASH_TOL": [c["case"] for c in fc
                                    if c["fails_max_gate"]],
                      "FLASH_ELEM_TOL": [c["case"] for c in fc
                                         if c["fails_elem_gate"]],
                      "LM": f_lm["failed"] if bf16 else []}
            record["faults"][name] = {"what": what, "cases": fc,
                                      "lm": f_lm, "caught": caught}
            print(f"fault {name} ({what}):", flush=True)
            for c in fc:
                print(f"  {describe(c)}", flush=True)
            if bf16:
                print(f"  LM bf16: final loss rel "
                      f"{f_lm['final_loss_rel']:.3g} decrease rel "
                      f"{f_lm['decrease_rel']:.3g} updates rel max "
                      f"{f_lm['update_rel_max']:.3g} "
                      f"({f_lm['update_rel_at']}) -> "
                      f"{'FAILS' if f_lm['failed'] else 'passes'}",
                      flush=True)
            print(f"  caught by FLASH_TOL in {len(caught['FLASH_TOL'])} of "
                  f"{len(fc)} cases, by FLASH_ELEM_TOL in "
                  f"{len(caught['FLASH_ELEM_TOL'])}, by the LM gates: "
                  f"{bool(caught['LM']) if bf16 else 'not run (f32)'}",
                  flush=True)
            if not any(caught.values()):
                bad.append(f"fault {name} passed every gate")
        use_library(sound_lib)
    with open(os.path.join(out_dir, "flash_gate_check.json"), "w") as f:
        json.dump(record, f, indent=1)
    print("flash_gate_check: " + ("; ".join(bad) if bad else "the sound "
          "source passes every gate and every fault fails one"), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
