"""Per-stage split of K3 in bf16 (gate, ``gate_launch``) and K15
(banded_mix_update, ``banded_mix_launch``) on one CUDA card, for this tree's
kernels (``csrc/band_mix.cuh`` ``band_mix_kernel``) and, with ``--parent
DIR``, for the kernels of the checkout at DIR (K3's ``gate_kernel<bf16>``
on a (stream, D-chunk) grid and K15's ``banded_mix_kernel``, from before
``band_mix.cuh``), in the same run.

Inputs as ``chip_smoke.py`` phase 4 makes them (B=384, seed 0): K3 on the
v3 path's features and embeddings of scans 0 and 1 at 456 rows a stream
(450 valid, window 11, D = 3584); K15 in bf16 on the first 450 rows of
those streams with K3's own attention (read back through a probe
template).

Each source is compiled twice with ``nvcc`` into ``build/stage_split/``:
as shipped, and instrumented, thread 0 of every block adding the
``%globaltimer`` time since its last mark into one of the buckets of
``BUCKETS`` (a block's own stages: barrier set-up and first copies, K3's
wait for its staged embeddings, the attention, the waits for the first and
for later chunks, the mix, the blend and store, the chunk barrier and the
refills; the parent kernels have the attention and one mix-and-store
loop). The instrumented kernels' outputs
are held to the bit against the shipped ones; the shipped kernels are timed
with CUDA events, and the achieved device-memory rate printed (x and
template read, the output written once; K3 adds zx, zt, new_z and sim).
Checks: this tree's K3 new template equals ``gate_mix_plain`` on its own
attention, its new_z and sim the parent's to the bit; K15 equals
``banded_mix_update_plain`` to the bit.

With ``--variants JSON`` this tree's K3 and K15 are also built from source
variants, each a copy of ``csrc`` with text replacements (``{"name":
[[file, old, new], ...]}``, as ``experiments/torch_gate_variants.py``
takes them), held to the bit against the shipped build and timed beside
it in turns. ``VARIANTS`` holds the ones ``PERF.md`` reports.

Run from the repo root: ``python3 experiments/torch_band_gate_split.py
[--parent DIR] [--variants JSON]``.
"""
import argparse
import ctypes
import json
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

SPLIT_DEF = r'''
__device__ unsigned long long* g_stamps;
// bucket i (i >= 0) gains the time since thread 0's last mark; slot 63
// holds the mark
#define SPLIT(i) do { if (g_stamps && threadIdx.x == 0) { \
  unsigned long long t_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
  unsigned long long* b_ = g_stamps + \
      ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 64; \
  if ((i) >= 0) b_[(i)] += t_ - b_[63]; b_[63] = t_; } } while (0)
'''
BUCKETS = ["barriers, zero rows, first copies", "attention",
           "wait, first chunk", "wait, later chunks", "mix", "blend and store",
           "chunk barrier", "refill", "embeddings staged (K3)"]
PARENT_BUCKETS = {1: "attention", 5: "mix and store"}
# (file, text, the mark put after it) of this tree's kernel (band_mix.cuh)
NEW_MARKS = [(
    "band_mix.cuh", text, mark) for text, mark in (
    ("  const MixTile g = mix_tile(mix_smem, ct, window, d * (int)sizeof(T), "
     "rows);\n", "SPLIT(-1);"),
    ("    mix_begin<true>(g, x, t, g.stages);\n", "SPLIT(0);"),
    ("          r < g.nr ? attn[(g.row0 + g.i0 + r) * window + k] : 0.0f;\n"
     "    }\n    __syncthreads();\n", "SPLIT(1);"),
    ("    mix_zero_rows(g, 0, zs ? last : g.stages);\n", "SPLIT(0);"),
    ("      mbar_wait(g.full + g.stages, 0);\n", "SPLIT(8);"),
    ("      if (lane < window) g.attn[lane * kMixRows + r] = a;\n    }\n"
     "    __syncthreads();\n", "SPLIT(1);"),
    ("      if (last < g.nch) mix_issue<false>(g, x, t, last);\n    }\n",
     "SPLIT(7);"),
    ("    mbar_wait(g.full + s, (ch / g.stages) & 1);\n",
     "SPLIT(ch == 0 ? 2 : 3);"),
    ("      mix_run<T, kCircular>(st + r0 * kMixPitch + lb, g.attn + r0, "
     "g.window,\n                            acc);\n", "SPLIT(4);"),
    ("          lane_store(o + (size_t)u * d, v);\n        }\n      }\n",
     "SPLIT(5);"),
    ("    __syncthreads();  // every warp is done with stage s\n", "SPLIT(6);"),
    ("    if (ch + g.stages < g.nch) mix_issue<kCircular>(g, x, t, ch + "
     "g.stages);\n", "SPLIT(7);"))]
# the source variants PERF.md reports (--variants default): one or four
# warps on a row chunk (64-row tiles of 256-byte chunks, 16 of 1024), copy
# q issued by thread q (the first warps issue a chunk's copies), and K3's
# attention reading zx and zt from device memory
_BM = "band_mix.cuh"
VARIANTS = {
    "slices1": [[_BM, "constexpr int kMixSlices = 2;",
                 "constexpr int kMixSlices = 1;"]],
    "slices4": [[_BM, "constexpr int kMixSlices = 2;",
                 "constexpr int kMixSlices = 4;"]],
    "copy_q_on_thread_q": [[_BM, "  const int q = (threadIdx.x & 31) * "
                            "kWarps + (threadIdx.x >> 5);",
                            "  const int q = threadIdx.x;"]],
    "embeddings_from_device": [[_BM, "const bool zs = ct_valid - 1 >= "
                                "g.i0 - g.hw;", "const bool zs = false;"]],
}
# the parent's kernels: the start, after the attention, after the mix loop
PARENT_MARKS = {
    "gate": [
        ("gate.cu", "  const size_t row0 = (size_t)blockIdx.x * ct;\n\n"
         "  // ---- banded attention", None),
        ("gate.cu", "  __syncthreads();\n\n  // ---- banded template mix on "
         "this block's D-chunk", None),
        ("gate.cu", "    store8(new_t + (row0 + i) * d + col, xv);\n  }\n",
         "__syncthreads(); SPLIT(5);")],
    "banded_mix": [
        ("banded_mix.cu", "  const size_t row0 = (size_t)blockIdx.x * ct;\n",
         "SPLIT(-1);"),
        ("banded_mix.cu", "  __syncthreads();\n\n  const int nvec", None),
        ("banded_mix.cu", "    store8(out + (row0 + i) * d + col, xv);\n  }\n",
         "__syncthreads(); SPLIT(5);")],
}
# texts that take their mark inside them (before the text's tail)
SPLIT_INSIDE = {
    "  const size_t row0 = (size_t)blockIdx.x * ct;\n\n  // ---- banded "
    "attention": "  const size_t row0 = (size_t)blockIdx.x * ct;\n  "
                 "SPLIT(-1);\n\n  // ---- banded attention",
    "  __syncthreads();\n\n  // ---- banded template mix on this block's "
    "D-chunk": "  __syncthreads();\n  SPLIT(1);\n\n  // ---- banded template "
               "mix on this block's D-chunk",
    "  __syncthreads();\n\n  const int nvec":
        "  __syncthreads();\n  SPLIT(1);\n\n  const int nvec",
}


def compile_lib(csrc, name, tag, marks=None, reps=()):
    """Start ``nvcc`` on a copy of ``csrc`` with the text replacements
    ``reps`` (instrumented with ``marks``, if given): (process, library
    path)."""
    dst = os.path.join(ROOT, "build", "stage_split", f"band-{tag}-{name}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    for f, old, new in reps:
        q = os.path.join(dst, f)
        body = open(q).read()
        assert body.count(old) == 1, (tag, f, old)
        open(q, "w").write(body.replace(old, new))
    if marks is not None:
        for f, text, mark in marks:
            q = os.path.join(dst, f)
            body = open(q).read()
            assert body.count(text) == 1, (tag, name, text)
            new = SPLIT_INSIDE[text] if mark is None else text + f"  {mark}\n"
            open(q, "w").write(body.replace(text, new))
        cu = os.path.join(dst, f"{name}.cu")
        body = open(cu).read()
        open(cu, "w").write(SPLIT_DEF + body + (
            '\nextern "C" int set_stamps(void* p) {\n'
            '  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n'))
    out = os.path.join(dst, f"{name}.so")
    return subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", out,
         os.path.join(dst, f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), out


def inputs(dev):
    """K3's and K15's inputs as chip_smoke.py's phase 4 makes them."""
    from planar_optical_flow_tpu_torch.infer.fast_gate import (
        gate_attention_probe,
    )
    from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs
    from planar_optical_flow_tpu_torch.ops.kernels import fold
    from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout

    model = cs_.build_model(0, dev)
    rng = np.random.default_rng(0)
    scans = torch.tensor(rng.uniform(0.5, 25.0, (2, cs_.BATCH, cs_.NUM_PTS)),
                         dtype=torch.float32, device=dev)
    det = model.dr_spaam
    gp = fold.fold_gate_params(det.gate, dtype=torch.bfloat16)
    c, p_pad, b, v = 56, 456, cs_.BATCH, cs_.NUM_PTS
    d = 14 * 256
    ckw = dict(num_cutout_pts=c, window_width=1.0, window_depth=0.5,
               padding_val=29.99, centered=True, area_mode=True, p_valid=v)
    layer1, tail = fold.backbone_stack_weights(det.backbone)
    laid = cs.backbone_weights_bf16(tail)
    out = [cs.backbone_bf16(cutout(F.pad(s, (0, p_pad - v)), **ckw), layer1,
                            laid, (gp.w, gp.b), l=c) for s in scans]
    (x, zx), (t, zt) = [(f.reshape(b, p_pad, d), z.reshape(b, p_pad, 128))
                        for f, z in out]
    k3 = dict(ct=p_pad, ct_valid=v, alpha=gp.alpha,
              window_size=gp.window_size,
              args=[a.reshape(b * p_pad, -1) for a in (zx, zt, x, t)])
    # K15 on the first 450 rows of each stream, K3's attention at ct = 450
    zx5, zt5, x5, t5 = (a[:, :v].contiguous() for a in (zx, zt, x, t))
    attn = gate_attention_probe(zx5.reshape(b * v, 128),
                                zt5.reshape(b * v, 128), ct=v,
                                window_size=gp.window_size)
    k15 = dict(ct=v, alpha=gp.alpha, window_size=gp.window_size, attn=attn,
               x=x5, t=t5)
    return k3, k15


def k3_call(lib, k3, outs):
    n, d = k3["args"][2].shape
    fn = lib.gate_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    ptrs = [a.data_ptr() for a in k3["args"] + outs]
    stream = _build.stream_ptr(outs[0].device)
    args = (*ptrs, n, d, k3["ct"], k3["ct_valid"], k3["window_size"], 512,
            float(k3["alpha"]), 1.0 - k3["alpha"], 0, stream)
    return lambda: _build.check(fn(*args), "gate_launch")


def k15_call(lib, k15, out, parent):
    b, ct, d = k15["x"].shape
    fn = lib.banded_mix_launch
    fn.restype = ctypes.c_int
    chunk = [512] if parent else []
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (4 + len(chunk)) \
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    args = (k15["attn"].data_ptr(), k15["x"].data_ptr(), k15["t"].data_ptr(),
            out.data_ptr(), b * ct, d, ct, k15["window_size"], *chunk,
            float(k15["alpha"]), 1.0 - k15["alpha"], 0,
            _build.stream_ptr(out.device))
    return lambda: _build.check(fn(*args), "banded_mix_launch")


def report(tag, stamps, n_blocks, labels, ms, gbytes):
    st = stamps.reshape(-1, 64)[:n_blocks].cpu().numpy().astype(np.int64)
    tot = st[:, :len(BUCKETS)].sum(1) / 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[{tag}] {ms:.4f} ms = {gbytes / ms * 1e3:.1f} GB/s ({gbytes * 1e3:.1f} "
          f"MB moved); {n_blocks} blocks ({n_blocks / sms:.1f} on each of "
          f"{sms} SMs), mean {tot.mean():.2f} us a block", flush=True)
    for i, lab in labels.items():
        us = st[:, i].mean() / 1e3
        print(f"[{tag}]   {us:9.2f} us ({us / tot.mean() * 100:5.1f}%)  "
              f"{lab}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the kernels before "
                    "band_mix.cuh")
    ap.add_argument("--variants", default="{}",
                    help='source variants, {"name": [[file, old, new], '
                    '...]}, or "default": VARIANTS')
    args = ap.parse_args()
    from planar_optical_flow_tpu_torch.infer import fast_gate as fg

    dev = torch.device("cuda")
    card = cs_.card_line()
    sides = {"new": os.path.join(ROOT, "planar_optical_flow_tpu_torch",
                                 "csrc")}
    if args.parent:
        sides["parent"] = os.path.join(os.path.abspath(args.parent),
                                       "planar_optical_flow_tpu_torch",
                                       "csrc")
    procs = {}
    for side, csrc in sides.items():
        for name in ("gate", "banded_mix"):
            marks = NEW_MARKS if side == "new" else PARENT_MARKS[name]
            procs[side, name, "shipped"] = compile_lib(csrc, name,
                                                       f"{side}-shipped")
            procs[side, name, "timed"] = compile_lib(csrc, name,
                                                     f"{side}-timed", marks)
    variants = (VARIANTS if args.variants == "default"
                else json.loads(args.variants))
    for v, reps in variants.items():
        for name in ("gate", "banded_mix"):
            procs["new", name, v] = compile_lib(sides["new"], name,
                                                f"new-{v}", reps=reps)
    _build.build_all(("cutout", "backbone_bf16", "gate"))
    libs = {}
    for key, (p, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"[split] nvcc {key} rc {p.returncode}\n{log}", flush=True)
            raise SystemExit(1)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {'/'.join(key)}] {line.strip()[:120]}")
        libs[key] = ctypes.CDLL(out)
    print(f"[split] on {card}", flush=True)
    with torch.inference_mode():
        k3, k15 = inputs(dev)
        n, d = k3["args"][2].shape
        b, ct5, _ = k15["x"].shape
        w = k3["window_size"]
        gb3 = (3.0 * n * d * 2 + 3.0 * n * 128 * 2 + n * w * 4) / 1e9
        gb15 = (3.0 * b * ct5 * d * 2 + b * ct5 * w * 4) / 1e9
        results = {}
        for side in sides:
            for name in ("gate", "banded_mix"):
                outs = {}
                for kind in ("shipped", "timed"):
                    lib = libs[side, name, kind]
                    if name == "gate":
                        o = [torch.empty_like(k3["args"][3]),
                             torch.empty_like(k3["args"][0]),
                             torch.empty(n, w, device=dev)]
                        call = k3_call(lib, k3, o)
                    else:
                        o = [torch.empty_like(k15["x"])]
                        call = k15_call(lib, k15, o[0], side == "parent")
                    call()
                    torch.cuda.synchronize()
                    outs[kind] = (o, call)
                same = all(torch.equal(a, r) for a, r in
                           zip(outs["timed"][0], outs["shipped"][0]))
                ms = cs_.time_ms(outs["shipped"][1], 20)
                lib = libs[side, name, "timed"]
                # the parent's grids: (stream, D / 512)
                ct = k3["ct"] if name == "gate" else ct5
                tiles = fg.band_mix_geometry(ct, w)[1] \
                    if side == "new" else d // 512
                blocks = (n // k3["ct"] if name == "gate" else b) * tiles
                stamps = torch.zeros(blocks * 64, dtype=torch.int64,
                                     device=dev)
                assert lib.set_stamps(ctypes.c_void_p(stamps.data_ptr())) == 0
                outs["timed"][1]()
                torch.cuda.synchronize()
                assert lib.set_stamps(ctypes.c_void_p(0)) == 0
                tag = f"{'K3' if name == 'gate' else 'K15'} {side}"
                print(f"[{tag}] instrumented equals shipped: {same}",
                      flush=True)
                labels = dict(enumerate(BUCKETS)) if side == "new" \
                    else PARENT_BUCKETS
                report(tag, stamps, blocks, labels, ms,
                       gb3 if name == "gate" else gb15)
                results[side, name] = outs["shipped"][0]
        for name in ("gate", "banded_mix") if variants else ():
            kinds = ["shipped", *variants]
            calls, same = {}, {}
            for kind in kinds:
                lib = libs["new", name, kind]
                if name == "gate":
                    o = [torch.empty_like(a) for a in results["new", name]]
                    calls[kind] = k3_call(lib, k3, o)
                else:
                    o = [torch.empty_like(results["new", name][0])]
                    calls[kind] = k15_call(lib, k15, o[0], False)
                calls[kind]()
                torch.cuda.synchronize()
                same[kind] = all(torch.equal(a, r) for a, r in
                                 zip(o, results["new", name]))
            turns = kinds + kinds[::-1]
            ms = [cs_.time_ms(calls[k], 20) for k in turns]
            print(f"[variants {'K3' if name == 'gate' else 'K15'}] turns "
                  + ", ".join(f"{k} {m:.4f}" for k, m in zip(turns, ms))
                  + f" ms; equal to shipped: {json.dumps(same)}", flush=True)
        zx, zt, x, t = k3["args"]
        new_t = results["new", "gate"][0]
        a = fg.gate_attention_probe(zx, zt, ct=k3["ct"],
                                    ct_valid=k3["ct_valid"], window_size=w)
        ok_t = torch.equal(new_t, fg.gate_mix_plain(
            a, x, t, ct=k3["ct"], ct_valid=k3["ct_valid"],
            alpha=k3["alpha"]))
        ref15 = fg.banded_mix_update_plain(k15["attn"], k15["x"], k15["t"],
                                           k15["alpha"], w)
        ok_15 = torch.equal(results["new", "banded_mix"][0], ref15)
        print(f"[split] K3 new_t equal to gate_mix_plain on its own "
              f"attention: {ok_t}; K15 equal to banded_mix_update_plain: "
              f"{ok_15}", flush=True)
        if "parent" in sides:
            same_z = [torch.equal(g, r) for g, r in
                      zip(results["new", "gate"][1:],
                          results["parent", "gate"][1:])]
            print(f"[split] K3 new_z, sim equal to the parent's: {same_z}",
                  flush=True)
    print(json.dumps({"split": "band_gate", "done": True}))


if __name__ == "__main__":
    main()
