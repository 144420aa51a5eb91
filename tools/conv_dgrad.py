"""Time the data gradient ("dgrad") of VGG-16's convolutions at 2PS row
shapes on the card: one cuDNN call over the whole batch against the same
call split along the batch.

For each of VGG-16's 13 convolutions (published widths, 224x224) this takes
the input slice that row 0 of 2PS with two rows holds at batch 768, the
plan of the ``vgg16.b768.budget72`` benchmark cell
(``core/twophase.py::module_boundaries``: the slice ``Conv._conv``
convolves, NHWC storage seen as NCHW, as the port lays it out), or with
``--base`` the whole 224 rows that the ``base`` engine convolves, and
times, with CUDA events, warm and in turns (median of three):

* ``one``: ``aten.convolution_backward`` over the whole batch, input
  gradient only (what autograd's ``ConvolutionBackward0`` issues);
* ``c<n>`` (``--chunks``): the same call on chunks of ``n`` images, each
  copied into one preallocated NHWC gradient;
* ``f<n>``: each such chunk's gradient as the forward convolution of the
  cotangent with the flipped, in/out-transposed weight, written by
  ``aten.cudnn_convolution.out`` into its slice of the gradient (checked
  in place: the slice's pointer and the values);
* ``p<MiB>`` (``--program-mib``): the program's own split,
  ``models/cnn/layers.py::conv_backward`` with its chunk bytes set to
  that many MiB.

Each variant also runs once under ``torch.profiler`` for its kernels' names
and once for its peak memory above what it was given.  ``--hold-gib``
allocates that much first, to time under the memory pressure of a
training step.  Run on the card:

    PYTHONPATH=src python tools/conv_dgrad.py --out conv_dgrad.json

Prints one JSON line a convolution, a table, and the card's name and
power limit; ``--out`` gets the whole record.
"""

import argparse
import json
import subprocess

import torch

#: the budget cell's batch and plan: 2PS with two rows; row 0 holds 217 of
#: the 224 input rows
BATCH, N_ROWS, ROW = 768, 2, 0
#: timed rounds, in turns; the median is kept
REPS = 3


def row_shapes(base: bool):
    """``(name, cin, cout, h, w)`` of each VGG-16 conv's input at row
    ``ROW`` of 2PS with ``N_ROWS`` rows, or whole (``base``); stride 1,
    padding 1: the output has the input's H."""
    from repro_torch.core.twophase import module_boundaries
    from repro_torch.models.cnn import vgg
    from repro_torch.models.cnn.layers import Conv, MaxPool
    mods = vgg.vgg16_modules(1.0)
    plan = module_boundaries(mods, 224, N_ROWS)
    out, cin, stage, j = [], 3, 1, 0
    for l, m in enumerate(mods):
        if isinstance(m, MaxPool):
            stage, j = stage + 1, 0
        if not isinstance(m, Conv):
            continue
        j += 1
        h = plan.heights[l] if base else \
            plan.bounds[l][ROW + 1] - plan.need_lo[l][ROW]
        out.append((f"conv{stage}_{j}", cin, m.cout, h, plan.heights[l]))
        cin = m.cout
    return out


def _nchw(shape, device, gen):
    n, c, h, w = shape
    return torch.randn((n, h, w, c), device=device, generator=gen) \
        .permute(0, 3, 1, 2)


def _dgrad(g, x, w):
    return torch.ops.aten.convolution_backward(
        g, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [True, False, False])[0]


def _nhwc_like(x):
    n, c, h, w = x.shape
    return torch.empty((n, h, w, c), device=x.device,
                       dtype=x.dtype).permute(0, 3, 1, 2)


def variants(chunks, program_mib=()):
    """``{name: fn(g, x, w, wf) -> dx}``."""
    out = {"one": lambda g, x, w, wf: _dgrad(g, x, w)}

    def copy(n):
        def fn(g, x, w, wf):
            dx = _nhwc_like(x)
            for i in range(0, x.shape[0], n):
                dx[i:i + n].copy_(_dgrad(g[i:i + n], x[i:i + n], w))
            return dx
        return fn

    def inplace(n):
        def fn(g, x, w, wf):
            dx = _nhwc_like(x)
            tf32 = torch.backends.cudnn.allow_tf32
            for i in range(0, x.shape[0], n):
                s = dx[i:i + n]
                ptr = s.data_ptr()
                torch.ops.aten.cudnn_convolution.out(
                    g[i:i + n], wf, [1, 1], [1, 1], [1, 1], 1, False, False,
                    tf32, out=s)
                if s.data_ptr() != ptr:
                    raise RuntimeError("cudnn_convolution.out moved its out")
            return dx
        return fn

    def program(mib):
        def fn(g, x, w, wf):
            from repro_torch.models.cnn import layers
            was = layers.DGRAD_SPLIT_BYTES, layers.DGRAD_CHUNK_BYTES
            layers.DGRAD_SPLIT_BYTES, layers.DGRAD_CHUNK_BYTES = 0, mib << 20
            try:
                return layers.conv_backward(g, x, w, 1, (1, 1),
                                            (True, False, False))[0]
            finally:
                layers.DGRAD_SPLIT_BYTES, layers.DGRAD_CHUNK_BYTES = was
        return fn

    for n in chunks:
        out[f"c{n}"] = copy(n)
    for n in chunks:
        out[f"f{n}"] = inplace(n)
    for mib in program_mib:
        out[f"p{mib}"] = program(mib)
    return out


def _kernels(fn, args):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    us = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            us[e.name()] = us.get(e.name(), 0.0) + \
                (e.end_ns() - e.start_ns()) / 1e3
    return sorted(us.items(), key=lambda kv: -kv[1])


def measure(shape, args, gen):
    name, cin, cout, h, wd = shape
    dev = "cuda"
    x = _nchw((BATCH, cin, h, wd), dev, gen)
    g = _nchw((BATCH, cout, h, wd), dev, gen)
    w = torch.randn((3, 3, cin, cout), device=dev, generator=gen) \
        .mul_((2.0 / (9 * cin)) ** 0.5).permute(3, 2, 0, 1)
    wf = w.transpose(0, 1).flip((2, 3)).contiguous(
        memory_format=torch.channels_last)
    vs = variants([n for n in args.chunks if n < BATCH], args.program_mib)
    want = _dgrad(g, x, w)
    scale = float(want.abs().max())
    rec = {"conv": name, "shape_nchw": [BATCH, cin, h, wd],
           "cout": cout, "in_gb": x.numel() * 4 / 1e9,
           "out_gb": g.numel() * 4 / 1e9,
           "dgrad_gflop": 2 * BATCH * h * wd * cin * cout * 9 / 1e9,
           "ms": {}, "rel_err": {}, "extra_peak_gb": {}, "kernels": {}}
    for v, fn in vs.items():
        got = fn(g, x, w, wf)
        rec["rel_err"][v] = max(
            float((got[i:i + 16] - want[i:i + 16]).abs().max())
            for i in range(0, BATCH, 16)) / scale
        del got
    del want
    for v, fn in vs.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dx = fn(g, x, w, wf)
        torch.cuda.synchronize()
        rec["extra_peak_gb"][v] = (torch.cuda.max_memory_allocated() - base
                                   - dx.numel() * 4) / 1e9
        del dx
        top = _kernels(fn, (g, x, w, wf))
        rec["kernels"][v] = [[k, round(t / 1e3, 3)] for k, t in top[:3]]
    times = {v: [] for v in vs}
    for _ in range(REPS):
        for v, fn in vs.items():
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            dx = fn(g, x, w, wf)
            b.record()
            torch.cuda.synchronize()
            times[v].append(a.elapsed_time(b))
            del dx
    rec["ms"] = {v: sorted(t)[len(t) // 2] for v, t in times.items()}
    rec["ms_all"] = times
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, nargs="*",
                    default=[384, 192, 96, 64, 32, 16],
                    help="images a chunk of the c<n> and f<n> variants")
    ap.add_argument("--convs", nargs="*", default=None,
                    help="names (conv1_2 ...); default all 13")
    ap.add_argument("--program-mib", type=int, nargs="*", default=[],
                    help="chunk sizes of the program's split to time")
    ap.add_argument("--hold-gib", type=float, default=0.0,
                    help="GiB to allocate before timing")
    ap.add_argument("--base", action="store_true",
                    help="the base engine's whole-height shapes")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_dgrad: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    head = {"card": smi.strip(), "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "cudnn": torch.backends.cudnn.version(),
            "batch": BATCH, "shapes": "base" if args.base else
            f"2PS N={N_ROWS} row {ROW}", "hold_gib": args.hold_gib}
    print(json.dumps(head), flush=True)
    hold = torch.empty(int(args.hold_gib * 2**30), dtype=torch.uint8,
                       device="cuda") if args.hold_gib else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    recs = []
    for shape in row_shapes(args.base):
        if args.convs and shape[0] not in args.convs:
            continue
        rec = measure(shape, args, gen)
        print(json.dumps(rec), flush=True)
        recs.append(rec)
        torch.cuda.empty_cache()
    names = list(recs[0]["ms"]) if recs else []
    print("conv      in_GB  out_GB  " + "  ".join(f"{v:>8}" for v in names)
          + "  one's kernel")
    for r in recs:
        print(f"{r['conv']:8} {r['in_gb']:6.2f} {r['out_gb']:6.2f}  "
              + "  ".join(f"{r['ms'][v]:8.2f}" for v in names)
              + "  " + r["kernels"]["one"][0][0][:60])
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**head, "convs": recs}, f, indent=1)
    del hold


if __name__ == "__main__":
    main()
