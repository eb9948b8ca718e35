"""Time design alternatives of the multi-tensor K6 (RMSProp) and K7
(AdaGrad) launches against the sound kernels, on one CUDA card.

Each alternative is a text edit of ``singa_tpu_torch/csrc/fused_optim.cu``.
The edited copies are written and built (one ``nvcc`` each, all started
together) under a temporary directory, never in the package, and loaded in
place of the sound library in turns: sound, alternative, alternative,
sound, ``ROUNDS`` times. Each turn holds the kernel bitwise against the
loop of plain versions and times a whole ResNet-50 update (its 161
parameter shapes, f32, as ``opt.RMSProp/AdaGrad(fused=True)`` sends them)
as the device time of ``scaled_multi_kernel`` (``torch.profiler``). The
program has no switch for any alternative: a kept one is edited into the
source.

    python3 optim_alternatives.py  # chiprun_out/optim_alternatives.json
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import chip_smoke as cs

ROUNDS = 3

# (element type) -> the machine word of one 4-element vector, for the
# streaming accesses below
_STREAM_HELPERS = """
template <int BYTES> struct Word;
template <> struct Word<16> { using T = int4; };
template <> struct Word<8> { using T = int2; };

// a whole vector read and written with the evict-first (streaming) hint:
// each array is touched once per step, and a step moves 470 MB
template <class T>
__device__ __forceinline__ Vec<T> ldcs(const Vec<T>* a) {
  using W = typename Word<sizeof(Vec<T>)>::T;
  const W w = __ldcs(reinterpret_cast<const W*>(a));
  return *reinterpret_cast<const Vec<T>*>(&w);
}

template <class T>
__device__ __forceinline__ void stcs(Vec<T>* a, const Vec<T>& v) {
  using W = typename Word<sizeof(Vec<T>)>::T;
  __stcs(reinterpret_cast<W*>(a), *reinterpret_cast<const W*>(&v));
}
"""
_VEC = """template <class T>
struct alignas(sizeof(T) * V) Vec {
  T e[V];
};
"""

# name: (what it changes, [(text, replacement), ...]); every occurrence of
# a text is replaced (the streaming edit reaches K1's and K5's spans too,
# which are not timed here)
ALTERNATIVES = {
    "tile_8192": ("8192 elements per block of a multi-tensor launch, not "
                  "4096", [("constexpr int TILE = 4096;",
                            "constexpr int TILE = 8192;")]),
    "streaming": ("the vector loop's loads and stores of p, g and the "
                  "state with the evict-first hint (__ldcs / __stcs)", [
                      (_VEC, _VEC + _STREAM_HELPERS),
                      ("Vec<typename P::T> pv = "
                       "reinterpret_cast<Vec<typename P::T>*>(p)[i];",
                       "Vec<typename P::T> pv = "
                       "ldcs(reinterpret_cast<Vec<typename P::T>*>(p) + i);"),
                      ("reinterpret_cast<const Vec<typename P::T>*>(g)[i];",
                       "ldcs(reinterpret_cast<const Vec<typename P::T>*>(g)"
                       " + i);"),
                      ("Vec<typename S::T> rv = "
                       "reinterpret_cast<Vec<typename S::T>*>(r)[i];",
                       "Vec<typename S::T> rv = "
                       "ldcs(reinterpret_cast<Vec<typename S::T>*>(r) + i);"),
                      ("reinterpret_cast<Vec<typename P::T>*>(p)[i] = pv;",
                       "stcs(reinterpret_cast<Vec<typename P::T>*>(p) + i, "
                       "pv);"),
                      ("reinterpret_cast<Vec<typename S::T>*>(r)[i] = rv;",
                       "stcs(reinterpret_cast<Vec<typename S::T>*>(r) + i, "
                       "rv);")]),
}


def resnet50_param_shapes():
    """The 161 parameter shapes of ResNet-50 with 10 classes: 53 convs
    (OIHW), 53 BN scales and biases, the fc weight and bias."""
    shapes = [(64, 3, 7, 7), (64,), (64,)]
    cin = 64
    for width, blocks in zip((64, 128, 256, 512), (3, 4, 6, 3)):
        for b in range(blocks):
            shapes += [(width, cin, 1, 1), (width,), (width,),
                       (width, width, 3, 3), (width,), (width,),
                       (4 * width, width, 1, 1), (4 * width,), (4 * width,)]
            if b == 0:
                shapes += [(4 * width, cin, 1, 1), (4 * width,),
                           (4 * width,)]
            cin = 4 * width
    return shapes + [(2048, 10), (10,)]


def build_copies(workdir):
    """``{name: library}``, each built from a copy of the source with its
    edits: every text must be found in the source."""
    from singa_tpu_torch import cuda_build
    src = (cuda_build.CSRC_DIR / "fused_optim.cu").read_text()
    procs = {}
    for name, (_, pairs) in ALTERNATIVES.items():
        text = src
        for old, new in pairs:
            cs.check(old in text, f"{name}: {old!r} is not in the source")
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


def use_library(path):
    """Load ``path`` in place of the optimizer library."""
    from singa_tpu_torch import cuda_build
    cuda_build._libs["fused_optim"] = ctypes.CDLL(path)


def turn(dev, mkind, shapes, gen):
    """One turn of the loaded library: bitwise against the loop of plain
    versions (mixed lr and weight decay), then the device ms of one whole
    update as the optimizer sends it."""
    import torch
    base = cs.MULTI_CASES[mkind][0]
    tensors, scalars = cs.optim_args(base, shapes, gen, dev)
    mine = cs.multi_entries(mkind, tensors, scalars, mixed=True)
    plain = cs.clone_entries(mine)
    cs.multi_update(mkind, mine, scalars)
    cs.multi_update(mkind, plain, scalars, plain=True)
    torch.cuda.synchronize()
    cs.check(all(torch.equal(a, b) for e, w in zip(mine, plain)
                 for a, b in ((e[0], w[0]), (e[2], w[2]))),
             f"{mkind}: differs from the loop of plain versions")
    del mine, plain
    entries = cs.multi_entries(mkind, tensors, scalars, mixed=False)
    return cs.device_ms(lambda: cs.multi_update(mkind, entries, scalars),
                        cs.KERNEL_NAME[mkind],
                        launches=cs.multi_chunks(mkind, len(shapes)))


def main():
    import torch
    if not torch.cuda.is_available():
        print("optim_alternatives: no CUDA device is available",
              file=sys.stderr)
        return 2
    from singa_tpu_torch import cuda_build, device
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    cuda_build.build(("fused_optim",))
    sound = str(cuda_build.library_path("fused_optim"))
    dev = device.create_cuda_gpu(0)
    gen = torch.Generator(device=dev.torch_device)
    gen.manual_seed(cs.SEED)
    shapes = resnet50_param_shapes()
    cs.check(len(shapes) == cs.PARAMS_PER_STEP, "161 shapes")
    record = {"card": card, "rounds": ROUNDS, "alternatives": {}}
    with tempfile.TemporaryDirectory() as work:
        libs = build_copies(work)
        for name, so in libs.items():
            rec = {"what": ALTERNATIVES[name][0]}
            for mkind in ("rmsprop_multi", "adagrad_multi"):
                r = {"sound": [], "alternative": []}
                for _ in range(ROUNDS):
                    for which in ("sound", "alternative", "alternative",
                                  "sound"):
                        use_library(sound if which == "sound" else so)
                        r[which].append(turn(dev, mkind, shapes, gen))
                use_library(sound)
                rec[mkind] = {
                    w: {"device_ms": x, "mean": statistics.mean(x),
                        "spread": max(x) - min(x)} for w, x in r.items()}
                s, a = rec[mkind]["sound"], rec[mkind]["alternative"]
                print(f"alternative {name} ({rec['what']}), {mkind} over "
                      f"{len(shapes)} ResNet-50 tensors, device ms sound "
                      f"{s['mean']:.4f} (spread {s['spread']:.4f}) -> "
                      f"alternative {a['mean']:.4f} (spread "
                      f"{a['spread']:.4f}); bitwise in every turn",
                      flush=True)
            record["alternatives"][name] = rec
    out_dir = os.path.join(cs.HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "optim_alternatives.json"), "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
