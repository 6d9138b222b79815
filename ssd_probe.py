#!/usr/bin/env python3
"""Where the SSD scan kernels' time goes, on one NVIDIA GPU.

  python3 ssd_probe.py

Times ``csrc/ssd_scan.cu`` (bf16, mamba2-2.7b's 80 heads of P = 64, G = 1,
N = 128; cold L2, chip_smoke's timing) in two ways:
  1. the chain: the same 2560 blocks as one-chunk sequences (no chain),
     as chains of 2, 8 and 16 chunks, and one wave of full chunks;
  2. knock-outs: copies of the source with one part removed (their results
     are wrong by design), built into build/ssd_probe/ and launched through
     the same wrapper: an empty launch, the loads and cumsum alone, no state
     stores, no exp in the scores, no scores @ x, no C B^T, no state
     update, no y warps, neither y warps nor state update.
Then ``csrc/ssd_scan_bwd.cu`` (bf16, no d(final), the forward kernel's chunk
states) at phase T's training steps, (B, S, H, P, G, N) = (4, 512, 80, 64,
1, 128) (mamba2-2.7b) and (4, 512, 64, 64, 1, 64) (zamba2-1.2b):
  3. as built, with the card's plan of heads a block and with one head a
     block;
  4. knock-outs, built the same way into build/ssd_probe/: an empty launch,
     the loads and cumsum alone, no chain term, no dx, dB or dC tiles (the
     products of M^T, dG^T or dG with a chunk operand), no tiles (those three
     and the G and dM products that feed them), no state products (B gn^T,
     x gn, dy h_c), no chain wait (nor flag release), no fence before the
     release, no work in pass B or in pass C after its loads, no sums launch.
Prints the card's name and power limit first. Imports nothing of JAX.
"""
import ctypes
import os
import subprocess
import sys

import torch

import chip_smoke as cs

SHAPES = [(1, 19, False), (1, 128, False), (1, 128, True), (16, 128, False), (16, 128, True),
          (8, 256, False), (2, 1024, False), (1, 2048, False), (1, 2048, True), (4, 4096, True)]
ABLATION_SHAPES = [(1, 19, False), (1, 128, False), (1, 2048, False)]
Y_ROLE = "  if (warp < NYW) {\n"
STATE_MMA = ("    mm_xtwb<MTW, NTW, LDP, LDN>(acc, xs_ + j0 * LDP + m0, bs_ + j0 * LDN + n0, "
             "wv + j0, lane);")
# name -> (text in the source, what replaces it), applied in order
KNOCKOUTS = {
    "empty": [("  const int tid = threadIdx.x,",
               "  if (S > 0) return;\n  const int tid = threadIdx.x,")],
    "loads_and_cumsum": [(Y_ROLE, "  if (S > 0) return;\n" + Y_ROLE)],
    "no_state_store": [(
        "        store2(hb + p * N + n, decay * prev[mt][nt][2 * hf] + acc[mt][nt][2 * hf],\n"
        "               decay * prev[mt][nt][2 * hf + 1] + acc[mt][nt][2 * hf + 1]);",
        "        if (acc[mt][nt][2 * hf] == 12345.f) hb[0] = decay;")],
    "no_exp": [("s[nt][e] * expf(cum[i] - cum[j]) * dts[j]", "s[nt][e] * dts[j]")],
    "no_scores_x": [("        mm_px<LDP>(acc[k], s, xs_ + j0 * LDP, lane);\n",
                     "        acc[k][0][0] += s[0][0] + s[1][3];\n")],
    "no_cbt": [("        mm_abt<N, 2>(reinterpret_cast<float(&)[4][4]>(s), cs_ + i0 * LDN, "
                "bs_ + j0 * LDN,\n                     LDN, lane);\n", ""),
               ("        mm_abt<N, 1>(s, cs_ + i0 * LDN, bs_ + j0 * LDN, LDN, lane);\n", "")],
    "no_state_update": [(STATE_MMA, "    acc[0][0][0] += wv[j0];")],
    "no_y_warps": [(Y_ROLE, Y_ROLE + "    if (S > 0) return;\n")],
    "no_y_warps_no_state_update": [(Y_ROLE, Y_ROLE + "    if (S > 0) return;\n"),
                                   (STATE_MMA, "    acc[0][0][0] += wv[j0];")],
}


BWD_SHAPES = [(4, 512, 80, 64, 1, 128), (4, 512, 64, 64, 1, 64)]
BWD_TILE = {"dx": "        frag_kmajor<P / 8>(dxa, gt, dys + i0 * LDP, LDP, lane);\n",
            "dB": "          frag_kmajor<N / 8>(dBa, mt, Cs + i0 * LDN, LDN, lane);\n",
            "dC": "        frag_kmajor<N / 8>(dCa, dm, Bs + j0 * LDN, LDN, lane);\n"}
BWD_GM = ["        g_tile(gt, Bs, Cs, i0, bj);\n",                 # passes A and B
          "          mm_bt<P, 2>(mt, xj, dys + i0 * LDP, LDP, lane);\n",
          "        g_tile(gg, Cs, Bs, j0, ci);\n",
          "        mm_bt<P, 2>(dm, dyi, xs + j0 * LDP, LDP, lane);\n"]
BWD_STATE = ["          mm_bt<N, P / 8>(dxa, Bs + r0 * LDN, LDN, ghi, LDN, lane);\n",
             "          mm_bt<N, P / 8>(dxa, Bs + r0 * LDN, LDN, glo, LDN, lane);\n",
             "          mm_bt<N, P / 8>(dxa, bj, ghi, LDN, lane);\n",
             "          mm_bt<N, P / 8>(dxa, bj, glo, LDN, lane);\n",
             "              mm_b<P, VG>(tmp, xj, ghi + gi * VG * 8, LDN, lane);\n",
             "              mm_b<P, VG>(tmp, xj, glo + gi * VG * 8, LDN, lane);\n",
             "          mm_b<P, VG>(tmp, dyi, ghi + n0, LDN, lane);\n",
             "          mm_b<P, VG>(tmp, dyi, glo + n0, LDN, lane);\n"]
PASS_A = "    const int sc = ((b * nc + c) * args.H + h) * P * N;  // this (batch, chunk, head)'s state\n"
PASS_B = "      decays(dts, args.A[h]);  // its barrier also publishes the pair\n"
PASS_C = "    decays(dts, a);  // its barrier also publishes the pair\n"
BWD_KNOCKOUTS = {
    "empty": [("  const int R = args.R;\n", "  if (args.S > 0) return;\n  const int R = args.R;\n")],
    "loads_and_cumsum": [(PASS_A, "    if (args.S > 0) continue;\n" + PASS_A),
                         (PASS_B, PASS_B + "      if (args.S > 0) continue;\n"),
                         (PASS_C, PASS_C + "    if (args.S > 0) continue;\n")],
    "no_chain_term": [("        chain_term<NTH>(u, dys + (warp % MT) * 16, LDP, Cs + n0, LDN, es, "
                       "(qn + 15) / 16, lane);\n", "")],
    "no_dx_tiles": [(BWD_TILE["dx"], "")],
    "no_dB_tiles": [(BWD_TILE["dB"], "")],
    "no_dC_tiles": [(BWD_TILE["dC"], "")],
    "no_tiles": [(t, "") for t in BWD_TILE.values()] + [(t, "") for t in BWD_GM],
    "no_state_products": [(t, "") for t in BWD_STATE],
    "no_chain_wait": [("        while (ld_acquire(flag) < nc - 1 - c) {\n        }\n", "        ;\n"),
                      ("          if (tid == 0) st_release(flag, nc - c);\n", "")],
    "no_publish_fence": [("          __threadfence();\n", "")],
    "no_pass_b_work": [(PASS_B, PASS_B + "      if (args.S > 0) continue;\n")],
    "no_pass_c_work": [(PASS_C, PASS_C + "    if (args.S > 0) continue;\n")],
    "no_sums_kernel": [("  ssd_bwd_sum_kernel<T><<<(unsigned)((sums + 255) / 256), 256, 0, stream>>>(\n"
                        "      args, N, (int)(nc * args.Bsz));\n", "")],
}


def _inputs(gen, b, s, with_h0):
    h, p, n = 80, 64, 128
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").bfloat16()
    dt = torch.empty((b, s, h), device="cuda").uniform_(0.001, 0.1, generator=gen)
    A = -torch.empty((h,), device="cuda").uniform_(1.0, 16.0, generator=gen)
    B = torch.randn((b, s, 1, n), generator=gen, device="cuda").bfloat16()
    C = torch.randn((b, s, 1, n), generator=gen, device="cuda").bfloat16()
    D = torch.randn((h,), generator=gen, device="cuda")
    h0 = torch.randn((b, h, p, n), generator=gen, device="cuda") if with_h0 else None
    return (x, dt, A, B, C, D), h0


def _build_knockouts(_build, source="ssd_scan", knockouts=KNOCKOUTS, entry="ssd_scan_fwd",
                     argtypes=None):
    """One library per knock-out of csrc/<source>.cu, all nvcc runs started
    together; returns each library's ``entry`` with ``argtypes``."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    out_dir = _build.BUILD_DIR / "ssd_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    running = {}
    for name, edits in knockouts.items():
        text = src
        for old, new in edits:
            assert old in text, f"{name}: the source no longer holds {old!r}"
            text = text.replace(old, new)
        cu, lib = out_dir / f"{source}_{name}.cu", out_dir / f"{source}_{name}.so"
        cu.write_text(text)
        running[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                                           str(cu)], stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in running.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"nvcc failed for the {name} knock-out:\n{log}"
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = argtypes or [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main():
    if not torch.cuda.is_available():
        print("ssd_probe: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ssd_scan as ssd

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card.splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def time_ms(args, h0):
        return cs._time_ms(lambda: ops.ssd_scan(*args, impl="kernel", initial_state=h0), 30, flush)

    for b, s, with_h0 in SHAPES:
        args, h0 = _inputs(gen, b, s, with_h0)
        chunks = -(-s // 128)
        print(f"probe chain (B, S) = ({b}, {s}) h0 {with_h0}: {chunks} chunks, "
              f"{chunks * b * 80 * 64 // ssd.COLUMNS} blocks, {time_ms(args, h0):.5f} ms",
              flush=True)
    kernel = ssd._kernel
    libs = {"as built": kernel(), **_build_knockouts(_build)}
    for b, s, with_h0 in ABLATION_SHAPES:
        args, h0 = _inputs(gen, b, s, with_h0)
        row = []
        for name, fn in libs.items():
            ssd._kernel = lambda fn=fn: fn
            row.append(f"{name} {time_ms(args, h0):.5f}")
        ssd._kernel = kernel
        print(f"probe knock-outs (B, S) = ({b}, {s}), ms: " + ", ".join(row), flush=True)

    # ---- the backward at phase T's shapes ----
    bwd = ssd._bwd_kernel
    bwd_libs = {"as built": bwd(), **_build_knockouts(
        _build, "ssd_scan_bwd", BWD_KNOCKOUTS, "ssd_scan_bwd", bwd().argtypes)}
    for b, s, h, p, g, n in BWD_SHAPES:
        x = torch.randn((b, s, h, p), generator=gen, device="cuda").bfloat16()
        dt = torch.empty((b, s, h), device="cuda").uniform_(0.001, 0.1, generator=gen)
        A = -torch.empty((h,), device="cuda").uniform_(1.0, 16.0, generator=gen)
        B = torch.randn((b, s, g, n), generator=gen, device="cuda").bfloat16()
        C = torch.randn((b, s, g, n), generator=gen, device="cuda").bfloat16()
        D = torch.randn((h,), generator=gen, device="cuda")
        dy = torch.randn((b, s, h, p), generator=gen, device="cuda").bfloat16()
        args = (x, dt, A, B, C, D)
        _, _, h_in = ssd.ssd_scan_kernel(*args, chunk=128, return_chunk_states=True)
        plan = ssd.bwd_heads_per_block(h, g, -(-s // 128) * b,
                                       ssd.bwd_slots(0, p, n, 128, torch.bfloat16))

        def time_bwd(r=None):
            return cs._time_ms(lambda: ssd.ssd_scan_bwd_kernel(
                *args, h_in, dy, None, chunk=128, heads_per_block=r), 30, flush)

        print(f"probe backward {[b, s, h, p, g, n]}: {plan} heads a block {time_bwd():.5f} ms, "
              f"1 head a block {time_bwd(1):.5f} ms", flush=True)
        row = []
        for name, fn in bwd_libs.items():
            ssd._bwd_kernel = lambda fn=fn: fn
            row.append(f"{name} {time_bwd():.5f}")
            torch.cuda.synchronize()
            for buf in ssd._syncs.values():  # a knock-out may leave the chain's flags set
                buf.zero_()
        ssd._bwd_kernel = bwd
        print(f"probe backward knock-outs {[b, s, h, p, g, n]}, ms: " + ", ".join(row),
              flush=True)


if __name__ == "__main__":
    main()
