"""Time variants of K1's d32 body (``csrc/flash_d32.cuh``) side by side on
the card, at the encoder's largest tile.

Each variant is a copy of ``csrc/`` with a few lines of the body replaced,
built by its own ``nvcc`` (all started together) under
``build/flash_d32_variants/<name>/``. Every variant is first held against
K1's plain version on the contract's cases (causal GQA, the encoder's
smallest bucket, a length-1 row, offsets and begins with an empty row, a
window that bites); then each is timed at ``enc_s512`` (B 64, 12 heads of
32, S 512, non-causal, the seed's lengths over 1-512, as in
``chip_smoke.py``), twice in turns, beside SDPA on the same inputs. One
JSON line a variant: ptxas's registers and spills, the largest error on
each case, and the times.

  body       the body as it is
  no_lo      P passed as bf16 hi only (one rounding of each weight: the
             numerics change; what the lo pass costs)
  bounds_4   launch bounds (128, 4) instead of (128, 6): fewer CTAs an SM
  bounds_5   ... (128, 5)
  stages_2   a 2-stage K/V ring instead of 3
  stages_4   ... 4 stages
  pv_smem    P V with P from shared memory (hi and lo tiles written by
             stmatrix), not wgmma's register operand
  bn_128     kv tiles of 128 rows (two m64n128k16 for S), bounds (128, 3)

Usage: python -m copilot_for_consensus_tpu_torch.scripts.flash_d32_variants
       [variant ...]
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

H = "flash_d32.cuh"
#: P V with P from shared memory (written by stmatrix in the 128-byte
#: swizzle, hi and lo tiles) instead of wgmma's register operand
_PV_HELPERS = r"""
// stmatrix x4: lane l gives the address of row l % 8 of matrix l / 8; its
// register i is its fragment of matrix i (the mma.sync layout)
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0,
                                        uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

// D[64 x 32] += A[64 x 16] * B[16 x 32], both from shared memory
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db));
}

// 2^x in one MUFU op; 2^-inf = 0"""
_PV_OLD = """    hop::mbar_wait(&s.v_full[st], parity);
    hop::fence_regs<16>(ph);
    hop::fence_regs<16>(pl);
    hop::fence_regs<16>(acc);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      hop::wgmma_rs_n32<1>(acc, ph + 4 * kk,
                           hop::desc_sw64(vs + kk * 16 * 64, TILE, 512), 1);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      hop::wgmma_rs_n32<1>(acc, pl + 4 * kk,
                           hop::desc_sw64(vs + kk * 16 * 64, TILE, 512), 1);"""
_PV_NEW = """    {
      const int r = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const int c = 2 * kk + (lane >> 4);
        const uint32_t off = r * 128 + ((c ^ (r & 7)) << 4);
        stsm_x4(hop::smem_u32(s.p[0]) + off, ph[4 * kk], ph[4 * kk + 1],
                ph[4 * kk + 2], ph[4 * kk + 3]);
        stsm_x4(hop::smem_u32(s.p[1]) + off, pl[4 * kk], pl[4 * kk + 1],
                pl[4 * kk + 2], pl[4 * kk + 3]);
      }
    }
    hop::fence_proxy_async();
    __syncthreads();
    hop::mbar_wait(&s.v_full[st], parity);
    hop::fence_regs<16>(acc);
    hop::wg_fence();
#pragma unroll
    for (int hl = 0; hl < 2; ++hl)
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_ss_n32(acc, hop::desc_sw128(
                              reinterpret_cast<const uint8_t*>(s.p[hl]) +
                                  kk * 32, 16, 1024),
                     hop::desc_sw64(vs + kk * 16 * 64, TILE, 512));"""
_BOUNDS = "__launch_bounds__(128, 6)"
VARIANTS: dict[str, list[tuple[str, str]]] = {
    "body": [],
    "no_lo": [("    for (int kk = 0; kk < BN / 16; ++kk)\n"
               "      hop::wgmma_rs_n32<1>(acc, pl + 4 * kk,",
               "    for (int kk = 0; kk < 0; ++kk)\n"
               "      hop::wgmma_rs_n32<1>(acc, pl + 4 * kk,")],
    "bounds_4": [(_BOUNDS, "__launch_bounds__(128, 4)")],
    "bounds_5": [(_BOUNDS, "__launch_bounds__(128, 5)")],
    "stages_2": [("constexpr int NSTAGE = 3;", "constexpr int NSTAGE = 2;")],
    "stages_4": [("constexpr int NSTAGE = 3;", "constexpr int NSTAGE = 4;")],
    "pv_smem": [("  alignas(1024) __nv_bfloat16 v[NSTAGE][BN * D];\n",
                 "  alignas(1024) __nv_bfloat16 v[NSTAGE][BN * D];\n"
                 "  alignas(1024) __nv_bfloat16 p[2][BM * BN];\n"),
                ("\n// 2^x in one MUFU op; 2^-inf = 0", _PV_HELPERS),
                (_PV_OLD, _PV_NEW)],
    "bn_128": [("constexpr int BN = 64; ", "constexpr int BN = 128;"),
               ("    float sc[32];", "    float sc[64];"),
               ("hop::fence_regs<32>(sc);", "hop::fence_regs<64>(sc);"),
               ("uint32_t ph[16], pl[16];", "uint32_t ph[32], pl[32];"),
               ("for (int i = 0; i < 16; ++i) split_p",
                "for (int i = 0; i < 32; ++i) split_p"),
               ("hop::fence_regs<16>(ph);\n    hop::fence_regs<16>(pl);",
                "hop::fence_regs<32>(ph);\n    hop::fence_regs<32>(pl);"),
               ("wgmma_ss_n64_zero<0>", "wgmma_ss_n128_zero<0>"),
               ("hop::wgmma_ss_n64<0>", "hop::wgmma_ss_n128<0>"),
               (_BOUNDS, "__launch_bounds__(128, 3)")],
}
#: (label, B, Hq, Hkv, S_q, S_kv, window, kv_lengths, q_offsets, kv_begins,
#: causal), all at head dim 32
CASES = [
    ("causal_gqa", 2, 8, 2, 300, 300, 4096, [300, 157], None, None, True),
    ("bucket32", 64, 12, 12, 32, 32, 0, [1 + i % 32 for i in range(64)],
     None, None, False),
    ("len1", 3, 12, 12, 96, 96, 0, [1, 96, 50], None, None, False),
    ("offsets_begins", 4, 8, 2, 200, 700, 4096, [700, 200, 356, 0],
     [500, 0, 100, 0], [0, 0, 50, 0], True),
    ("window100", 2, 8, 2, 600, 600, 100, [600, 450], None, None, True),
]
ENC_B, ENC_H, ENC_S = 64, 12, 512


def build(names) -> dict:
    """One patched copy of csrc/ and one nvcc a variant, all at once; the
    loaded entry points and ptxas's word on the d32 kernel, by name."""
    from copilot_for_consensus_tpu_torch.ops import _build

    root = _build.BUILD_DIR.parent / "flash_d32_variants"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name in names:
        d = root / name
        shutil.copytree(_build.CSRC, d)
        src = (d / H).read_text()
        for old, new in VARIANTS[name]:
            if old not in src:
                raise ValueError(f"{name}: {old!r} is not in {H}")
            src = src.replace(old, new)
        (d / H).write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "flash_attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        fn = ctypes.CDLL(str(root / name / "lib.so")).flash_attention_d32_fwd
        fn.argtypes = _build.SIGNATURES["flash_attention"][
            "flash_attention_d32_fwd"]
        fn.restype = ctypes.c_int
        built[name] = (fn, _ptxas(log))
    return built


def _ptxas(log: str) -> dict:
    """Registers and spill bytes ptxas reports for the d32 kernel."""
    text = log[log.find("flash_d32"):]
    regs = re.search(r"Used (\d+) registers", text)
    spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       text)
    return {"registers": int(regs.group(1)) if regs else None,
            "spill_bytes": (int(spills.group(1)) + int(spills.group(2))
                            if spills else None)}


def time_ms(fn, n: int = 10) -> float:
    """Median device time of ``fn`` over ``n`` launches, each between CUDA
    events after a ~1 ms device sleep (the host's enqueue not counted)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[n // 2]


def main(argv: list[str]) -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from copilot_for_consensus_tpu_torch.ops import flash_attention as fa
    from copilot_for_consensus_tpu_torch.scripts.probe_stream import card

    if not torch.cuda.is_available():
        print("flash_d32_variants: no CUDA device is available",
              file=sys.stderr)
        return 2
    names = argv or list(VARIANTS)
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        print(f"flash_d32_variants: unknown variants {unknown}; "
              f"known: {sorted(VARIANTS)}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(json.dumps({"card": card(), "variants": names}), flush=True)
    built = build(names)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def inputs(b, hq, hkv, s_q, s_kv, lens, offs, begins):
        q, k, v = (torch.randn(b, h, s, 32, generator=g, device=dev)
                   .bfloat16() for h, s in ((hq, s_q), (hkv, s_kv),
                                            (hkv, s_kv)))
        rows = fa._row_params(b, s_kv, lens, offs, begins, dev)
        return q, k, v, rows

    def call(fn, q, k, v, rows, causal, window):
        out = torch.empty_like(q)
        b, hq, s_q, _ = q.shape
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *(r.data_ptr() for r in rows), b, hq, k.shape[1], s_q,
                 k.shape[2], 32, int(causal), window, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    errors = {name: {} for name in names}
    for label, b, hq, hkv, s_q, s_kv, window, lens, offs, begins, causal \
            in CASES:
        q, k, v, rows = inputs(b, hq, hkv, s_q, s_kv, lens, offs, begins)
        ref = fa.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     kv_lengths=rows[0], q_offsets=rows[1],
                                     kv_begins=rows[2]).float()
        for name, (fn, _) in built.items():
            out = call(fn, q, k, v, rows, causal, window)
            errors[name][label] = (out.float() - ref).abs().max().item()
    lens = np.random.default_rng(0).integers(1, ENC_S + 1,
                                             size=ENC_B).tolist()
    q, k, v, rows = inputs(ENC_B, ENC_H, ENC_H, ENC_S, ENC_S, lens, None,
                           None)
    ref = fa.flash_attention_ref(q, k, v, causal=False,
                                 kv_lengths=rows[0]).float()
    mask = fa._mask(ENC_B, ENC_S, ENC_S, *rows, causal=False, window=0,
                    device=dev)[:, None]
    times = {name: [] for name in names}
    sdpa = []
    for _ in range(2):
        for name, (fn, _) in built.items():
            times[name].append(time_ms(
                lambda fn=fn: call(fn, q, k, v, rows, False, 0)))
        sdpa.append(time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask)))
    for name, (fn, ptxas) in built.items():
        out = call(fn, q, k, v, rows, False, 0)
        errors[name]["enc_s512"] = (out.float() - ref).abs().max().item()
        print(json.dumps({"variant": name, **ptxas,
                          "enc_s512_ms": times[name],
                          "max_abs_err": errors[name]}), flush=True)
    print(json.dumps({"variant": "sdpa", "enc_s512_ms": sdpa}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
