"""Per-stage split of K1 (cutout, ``cutout_launch``) on one CUDA card, for
this tree's kernel (``csrc/cutout.cu``: tiles of beams of one stream) and,
with ``--parent DIR``, for the K1 of the checkout at DIR (one block a
stream before it), in the same run.

Inputs as ``chip_smoke.py`` phase 4 makes them: scan 0 of the seeded scans
(B=384, 450 beams, ranges 0.5-25 m) padded to 456 rows a stream, 56 taps,
area mode, ``p_valid`` 450.

Each source is compiled with ``nvcc`` into ``build/stage_split/``: as
shipped, and (this tree's) instrumented: thread 0 of every block adds the
``%globaltimer`` time since its last mark into one of the buckets of
``BUCKETS`` (warp 0's prefix sums, the wait at the barrier, the taps up to
the store's barrier, the store), and the block's last thread the time of
its own beam's geometry and of its share of the window's load. The
instrumented kernel's cutouts are held to the
bit against the shipped ones, and the shipped kernels' to the parent's.
Times: the device time of one launch from ``torch.profiler`` (the kernel
alone), in turns, and the achieved device-memory rate (the scan read once,
the cutouts written once).

With ``--variants JSON`` this tree's K1 is also built from source variants,
each a copy of ``csrc`` with text replacements (``{"name": [[file, old,
new], ...]}``), held to the bit against the shipped build and timed beside
it in turns. ``default_variants()`` (``--variants default``) holds the
ones ``PERF.md`` reports: beams a tile, one block a stream, two beams a
warp in flight, the store path and the thread mapping. The split also
times K16 (this tree's ``row_shift``) on its known-answer pattern.

Run from the repo root: ``python3 experiments/torch_cutout_split.py
[--parent DIR] [--variants JSON]``.
"""
import argparse
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs_  # noqa: E402
from planar_optical_flow_tpu_torch.ops.kernels import _build  # noqa: E402
from planar_optical_flow_tpu_torch.ops.kernels import (  # noqa: E402
    cutout_kernel as ck,
)

SPLIT_DEF = r'''
__device__ unsigned long long* g_stamps;
// bucket i (i >= 0) gains the time since thread 0's last mark (slot 63);
// GSPLIT the same for the block's last thread (slot 62)
#define SPLIT_AT(tid, slot, i) do { if (g_stamps && threadIdx.x == (tid)) { \
  unsigned long long t_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
  unsigned long long* b_ = g_stamps + \
      ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 64; \
  if ((i) >= 0) b_[(i)] += t_ - b_[slot]; b_[slot] = t_; } } while (0)
#define SPLIT(i) SPLIT_AT(0, 63, i)
#define GSPLIT(i) SPLIT_AT(blockDim.x - 1, 62, i)
'''
BUCKETS = ["load the window (after its beam's geometry)",
           "prefix sums (warp 0)", "one beam's geometry",
           "wait at the barrier", "taps, to the store's barrier", "store"]
THREAD0 = [1, 3, 4, 5]  # thread 0's buckets; 0 and 2 are the last thread's
_CU = "cutout.cu"
# (text, the mark put after it) of this tree's cutout.cu
MARKS = [
    ("  const int nw = we - ws;\n", "SPLIT(-1); GSPLIT(-1);"),
    ("      if (lane < n1) tot[lane] = l1;\n    }\n", "SPLIT(1);"),
    ("                                half_alpha_of(dist, cfg.half_width), "
     "cfg);\n    }\n", "GSPLIT(2);"),
    ("      r_w[j] = __ldg(scan + ws + j);\n", "GSPLIT(0);"),
    ("  __syncthreads();  // the window, its prefix sums and the geometry "
     "staged\n", "SPLIT(3);"),
    ("  __syncthreads();  // the tile staged, visible to the copy engine\n",
     "SPLIT(4);"),
    ("  if (threadIdx.x == 0 && qe > qa) bulk_wait_read();\n", "SPLIT(5);"),
]
# the store by 16-byte stores of every thread, in place of the bulk copy
STORE16 = [
    [_CU, """  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
  __syncthreads();  // the tile staged, visible to the copy engine
  if (threadIdx.x == 0 && qe > qa)
    bulk_copy_s2g(dst + qa, out_s + qa, (uint32_t)(qe - qa) * 4u);
""", """  __syncthreads();
  for (int q4 = qa / 4 + threadIdx.x; q4 < qe / 4; q4 += kCutoutThreads)
    reinterpret_cast<float4*>(dst)[q4] =
        reinterpret_cast<const float4*>(out_s)[q4];
"""],
    [_CU, "  if (threadIdx.x == 0 && qe > qa) bulk_wait_read();\n", ""]]
# the tile's (beam, tap) pairs in one walk over the block's threads, in
# place of a warp a beam
FLAT_WALK = [[_CU, """  for (int bi = warp; bi < nv; bi += kCutoutWarps) {
    const BeamGeom g = geo_s[bi];
    float* o = out_s + h + bi * c;
    for (int k = lane; k < c; k += 64) {  // taps k and k + 32 together
      const float v0 = beam_tap<true>(g, (float)k, r, cs, cfg);
      const float v1 =
          beam_tap<true>(g, (float)min(k + 32, c - 1), r, cs, cfg);
      o[k] = v0;
      if (k + 32 < c) o[k + 32] = v1;
    }
  }
""", """  (void)warp;
  (void)lane;
  const int db = kCutoutThreads / c, dk = kCutoutThreads - db * c;
  int bi = threadIdx.x / c, k = threadIdx.x - bi * c;
  while (bi < nv) {
    out_s[h + bi * c + k] = beam_tap<true>(geo_s[bi], (float)k, r, cs, cfg);
    bi += db;
    k += dk;
    if (k >= c) {
      k -= c;
      ++bi;
    }
  }
"""]]


def _const(name, value):
    """A variant's replacement of ``constexpr int name = ...;``."""
    import re

    body = open(os.path.join(ROOT, "planar_optical_flow_tpu_torch", "csrc",
                             _CU)).read()
    old = re.search(rf"constexpr int {name} = [^;]*;", body).group(0)
    return [_CU, old, f"constexpr int {name} = {value};"]


def default_variants():
    """Beams a tile, two beams a warp in flight, the 16-byte-store path,
    the flat walk of (beam, tap) pairs, and one block a stream of 1,024
    threads."""
    return {
        "tile16_threads256": [_const("kCutoutTile", 16),
                              _const("kCutoutThreads", 256)],
        "tile32": [_const("kCutoutTile", 32)],
        "tile256": [_const("kCutoutTile", 256)],
        "beams_unroll2": [[_CU, "  for (int bi = warp; bi < nv; bi += "
                           "kCutoutWarps) {\n", "#pragma unroll 2\n  for "
                           "(int bi = warp; bi < nv; bi += kCutoutWarps) {\n"]],
        "store16": STORE16,
        "flat_walk": FLAT_WALK,
        "stream_block": [_const("kCutoutTile", 456),
                         _const("kCutoutThreads", 1024)],
    }


def compile_lib(csrc, tag, marks=None, reps=()):
    """Start ``nvcc`` on a copy of ``csrc`` with the text replacements
    ``reps`` (instrumented with ``marks``, if given): (process, library
    path)."""
    dst = os.path.join(ROOT, "build", "stage_split", f"cutout-{tag}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    cu = os.path.join(dst, _CU)
    for f, old, new in reps:
        q = os.path.join(dst, f)
        body = open(q).read()
        assert body.count(old) == 1, (tag, f, old)
        open(q, "w").write(body.replace(old, new))
    if marks is not None:
        body = open(cu).read()
        for text, mark in marks:
            if text not in body:  # a path the build does not have
                continue
            assert body.count(text) == 1, (tag, text)
            body = body.replace(text, text + f"  {mark}\n")
        open(cu, "w").write(SPLIT_DEF + body + (
            '\nextern "C" int set_stamps(void* p) {\n'
            '  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n'))
    out = os.path.join(dst, "cutout.so")
    return subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", out, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


def k1_call(lib, scan_p, out, ckw):
    """A launch of ``lib``'s K1 on ``scan_p`` into ``out``, the arguments
    as the wrapper passes them."""
    fn = lib.cutout_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
        + [ctypes.c_float] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    b, p = scan_p.shape
    c = ckw["num_cutout_pts"]
    args = (scan_p.data_ptr(), out.data_ptr(), b, p, ckw["p_valid"], c,
            ckw["window_width"], ckw["window_depth"], ckw["padding_val"],
            ck.recip(c - 1), ck.recip(math.radians(0.5)),
            ck.recip(ckw["window_depth"]), 1, 1,
            _build.stream_ptr(scan_p.device))
    return lambda: _build.check(fn(*args), "cutout_launch")


def device_ms(call, kernel="cutout_kernel", iters=20):
    """Mean device time (ms) of one launch of the device operations whose
    name holds ``kernel``, from ``torch.profiler`` over ``iters`` calls
    after one warm-up call: the kernel alone, without host work or the
    gaps between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    durs = [ev.time_range.end - ev.time_range.start for ev in prof.events()
            if ev.device_type == DeviceType.CUDA and kernel in ev.name]
    assert durs, f"the profiler recorded no {kernel}"
    return sum(durs) / len(durs) / 1e3


def report(tag, st, ms, mbytes):
    tot = st[:, THREAD0].sum(1) / 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = st.shape[0]
    print(f"[{tag}] {ms:.4f} ms = {mbytes / ms:.1f} GB/s ({mbytes:.1f} MB "
          f"moved); {n} blocks ({n / sms:.1f} on each of {sms} SMs), mean "
          f"{tot.mean():.3f} us a block (thread 0)", flush=True)
    for i, lab in enumerate(BUCKETS):
        us = st[:, i].mean() / 1e3
        who = "thread 0" if i in THREAD0 else "last thread"
        print(f"[{tag}]   {us:9.3f} us ({us / tot.mean() * 100:5.1f}%)  "
              f"{lab} ({who})", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the K1 before this one")
    ap.add_argument("--variants", default="{}",
                    help='source variants, {"name": [[file, old, new], '
                    '...]}, or "default": the ones PERF.md reports')
    args = ap.parse_args()
    dev = torch.device("cuda")
    card = cs_.card_line()
    csrc = os.path.join(ROOT, "planar_optical_flow_tpu_torch", "csrc")
    procs = {"shipped": compile_lib(csrc, "shipped"),
             "timed": compile_lib(csrc, "timed", MARKS)}
    if args.parent:
        procs["parent"] = compile_lib(
            os.path.join(os.path.abspath(args.parent),
                         "planar_optical_flow_tpu_torch", "csrc"), "parent")
    variants = (default_variants() if args.variants == "default"
                else json.loads(args.variants))
    for v, reps in variants.items():
        procs[v] = compile_lib(csrc, v, reps=reps)
    libs = {}
    for key, (p, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"[split] nvcc {key} rc {p.returncode}\n{log}", flush=True)
            raise SystemExit(1)
        regs = cs_.kernel_registers(log, "cutout_kernel")
        spills = cs_.kernel_ptxas(log, "cutout_kernel")[1]
        print(f"[ptxas {key}] cutout_kernel: {regs} registers, {spills} "
              f"bytes spilled", flush=True)
        libs[key] = ctypes.CDLL(out)
    print(f"[split] on {card}", flush=True)

    rng = np.random.default_rng(0)
    scans = torch.tensor(rng.uniform(0.5, 25.0, (cs_.STEPS, cs_.BATCH,
                                                  cs_.NUM_PTS)),
                         dtype=torch.float32, device=dev)
    p_pad = -(-cs_.NUM_PTS // 8) * 8
    scan_p = F.pad(scans[0], (0, p_pad - cs_.NUM_PTS)).contiguous()
    b = scan_p.shape[0]
    c = cs_.CUTOUT_KW["num_cutout_pts"]
    ckw = dict(num_cutout_pts=c, window_width=1.0, window_depth=0.5,
               padding_val=29.99, p_valid=cs_.NUM_PTS)
    mbytes = (4.0 * b * p_pad + 4.0 * b * p_pad * c) / 1e6
    outs, calls = {}, {}
    with torch.inference_mode():
        for key, lib in libs.items():
            outs[key] = torch.empty(b * p_pad, c, device=dev)
            calls[key] = k1_call(lib, scan_p, outs[key], ckw)
            calls[key]()
        torch.cuda.synchronize()
        same = {k: torch.equal(o, outs["shipped"]) for k, o in outs.items()}
        print(f"[split] equal to the shipped build to the bit: "
              f"{json.dumps(same)}", flush=True)
        ref = ck.cutout_plain(scan_p, angle_inc=math.radians(0.5),
                              centered=True, area_mode=True, **ckw)
        rows_eq = (outs["shipped"] == ref).all(-1)
        print(f"[split] shipped vs cutout_plain: {int((~rows_eq).sum())} of "
              f"{rows_eq.numel()} cutouts differ", flush=True)

        n_blocks = b * -(-p_pad // ck.CUTOUT_TILE)
        stamps = torch.zeros(n_blocks * 64, dtype=torch.int64, device=dev)
        lib = libs["timed"]
        assert lib.set_stamps(ctypes.c_void_p(stamps.data_ptr())) == 0
        calls["timed"]()
        torch.cuda.synchronize()
        assert lib.set_stamps(ctypes.c_void_p(0)) == 0
        st = stamps.reshape(n_blocks, 64).cpu().numpy().astype(np.int64)
        turns = ["shipped", "parent", "parent", "shipped"] \
            if "parent" in libs else ["shipped", "shipped"]
        ms = [device_ms(calls[k]) for k in turns]
        print("[split] turns " + ", ".join(f"{k} {m:.5f}" for k, m in
                                            zip(turns, ms)) + " ms", flush=True)
        report("K1 new", st, float(np.mean([m for k, m in zip(turns, ms)
                                             if k == "shipped"])), mbytes)
        if "parent" in libs:
            pm = float(np.mean([m for k, m in zip(turns, ms)
                                if k == "parent"]))
            print(f"[K1 parent] {pm:.4f} ms = {mbytes / pm:.1f} GB/s; "
                  f"{b} blocks (one a stream)", flush=True)
        # K16 (this tree's wrapper) on its known-answer pattern
        from planar_optical_flow_tpu_torch.ops.kernels import conv_stack
        x_np, l, _, _ = conv_stack.row_shift_pattern()
        x = torch.from_numpy(x_np).to(dev)
        k16 = device_ms(lambda: conv_stack.row_shift(x, l=l),
                        "row_shift_kernel")
        print(f"[split] K16 (row_shift) on the 8 x 128 pattern: {k16:.5f} ms "
              f"of device time a launch", flush=True)
        if variants:
            kinds = ["shipped", *variants]
            turns = kinds + kinds[::-1]
            ms = [device_ms(calls[k]) for k in turns]
            print("[variants K1] turns " + ", ".join(
                f"{k} {m:.5f}" for k, m in zip(turns, ms)) + " ms; equal to "
                f"shipped: {json.dumps({k: same[k] for k in kinds})}",
                flush=True)
    print(json.dumps({"split": "cutout", "done": True}))


if __name__ == "__main__":
    main()
