#!/usr/bin/env python3
"""Where the time of the port's serving path or training step goes, on one
CUDA device.

  python scripts/torch_port_profile.py [--whole-volume] [--use-pallas] [--mesh 1,2 [--devices cuda:0,cuda:1]]
  python scripts/torch_port_profile.py --train [--use-pallas]
  python scripts/torch_port_profile.py --multistage {pretrain,transfer,finetune}

Serving: one (96, 128, 128, 24) pc-bSSFP volume with the full-width
generator (bf16, packed, seeded random weights). ``--train``: full-width GAN
training steps of the default config (bf16, packed, batch 8 × 64³) from
``create_gan_state``. ``--mesh DATA,SPACE`` serves through a (data, space)
mesh (the halo exchange, K5 and the norms' moments summed over ``space``)
whose positions all lie on ``cuda:0``, or go to ``--devices cuda:0,cuda:1``
in turn. Times ``--reps`` of them on the host's clock after three warm-ups,
then runs ``--reps`` more under ``torch.profiler`` and prints the unprofiled
time and the device time per volume or step, by kernel name
and grouped by layer (the port's kernels, cuDNN, ATen's elementwise,
reduction and copy kernels, the optimizer), plus the device's busy share of
the profiled window and the number of kernels launched. Writes the tables to
``perf_out/torch_port_profile_<mode>.json``.

``--multistage STAGE``: one bf16 supervised step of the multi-stage stage at
the thesis widths (``MultiInputUNet``, packed, batch 8 × 64³, the stage's
frozen leaves frozen) split by layer: each block of the net (the head, the
U-Net's ten blocks) runs in a ``record_function`` range, its forward
kernels are those launched inside it and its backward kernels those of the
autograd nodes its forward ops made (matched by sequence number); within a
layer, the convs (K1/K2/K3, cuDNN) against the rest of the chain (norm,
dropout, activation, casts, pools). Then the same with every PReLU replaced
by a LeakyReLU of slope 0.25 (the slopes' initial value; they take no
gradient then): the step and each layer's chain beside the PReLU one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# (group, substrings of the kernel name), first match wins.
GROUPS = (
    ("K4 norm_act", ("norm_act_kernel",)),
    ("K1/K5 conv3x3_packed (fwd + dgrad, SAME and halo)", ("conv3x3_wgmma_",
                                                            "conv3x3_packed_")),
    ("K2 conv3x3_wgrad", ("conv3x3_wgrad_",)),
    ("K3 transposes", ("transpose_kernel",)),
    ("cuDNN/cuBLAS convs and GEMMs", ("xmma", "cudnn", "nvjet", "gemm", "cutlass",
                                      "conv", "wgrad", "dgrad")),
    ("optimizer (AdamW)", ("multi_tensor", "adam", "foreach")),
    ("ATen reductions", ("reduce_kernel", "Reduce")),
    ("pools and scatters", ("max_pool", "scatter", "argmax")),
    ("ATen dtype/layout copies", ("copy", "Cat", "Memcpy", "Memset", "Fill")),
    ("ATen elementwise", ("elementwise",)),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


LAYER_PREFIX = "layer:"
CONV_GROUPS = {"K1/K5 conv3x3_packed (fwd + dgrad, SAME and halo)", "K2 conv3x3_wgrad",
               "K3 transposes", "cuDNN/cuBLAS convs and GEMMs"}


def annotate_layers(net) -> None:
    """Run each block of a ``MultiInputUNet`` (its head, the U-Net's blocks
    and final conv) inside a ``record_function`` range ``layer:<name>``."""
    from torch.profiler import record_function

    names = {id(m): n for n, m in net.named_modules()}
    unet = net.unet

    def ranged(name, fn):
        def call(*a, **kw):
            with record_function(LAYER_PREFIX + name):
                return fn(*a, **kw)
        return call

    block = unet._block
    unet._block = lambda module, fn, *a: ranged(names[id(module)], block)(module, fn, *a)
    head = getattr(net, net.head_name)
    head.forward = ranged(net.head_name, head.forward)
    final = unet.final_conv
    for attr in ("forward", "forward_packed"):
        if hasattr(final, attr):
            setattr(final, attr, ranged("unet.final_conv", getattr(final, attr)))


def leaky_relu_instead(net, slope: float = 0.25) -> int:
    """Every PReLU block of ``net`` activated by LeakyReLU(``slope``)
    instead; returns how many."""
    import torch.nn.functional as F

    from unet_bssfp_tpu_torch.models.layers import ConvNormAct

    n = 0
    for m in net.modules():
        if isinstance(m, ConvNormAct) and m.prelu:
            m._act = lambda x, channel_dim, _s=slope: F.leaky_relu(x, _s)
            n += 1
    return n


def layer_split(prof, reps: int, device: bool = True) -> dict:
    """ms per rep by (layer, forward/backward, convs/chain) from a
    profile of annotated steps: a CPU op's kernels go to the layer whose
    range holds it (forward) or whose forward op made its autograd node
    (backward, by sequence number); the rest to the optimizer, or ``rest``
    (loss, casts outside the blocks). ``device=False`` splits the ops' own
    CPU time instead (a rehearsal without a card)."""
    events = prof.events()

    def layer_of(ev):
        while ev is not None:
            if ev.name.startswith(LAYER_PREFIX):
                return ev.name[len(LAYER_PREFIX):]
            ev = ev.cpu_parent
        return None

    cpu = [ev for ev in events if not ev.name.startswith(LAYER_PREFIX)
           and getattr(ev, "device_type", None) is not None
           and ev.device_type.name == "CPU"]
    by_seq = {}
    for ev in cpu:
        if ev.sequence_nr >= 0 and "Backward" not in ev.name and \
                not ev.name.startswith("autograd::"):
            lab = layer_of(ev)
            if lab is not None:
                by_seq.setdefault(ev.sequence_nr, lab)
    out = {}
    for ev in cpu:
        items = ([(k.name, k.duration) for k in ev.kernels] if device
                 else [(ev.name, ev.self_cpu_time_total)])
        if not items:
            continue
        lab, phase = layer_of(ev), "forward"
        if lab is None:
            phase, e = "backward", ev
            while e is not None and lab is None:
                if ("Backward" in e.name or e.name.startswith("autograd::")) and \
                        e.sequence_nr in by_seq:
                    lab = by_seq[e.sequence_nr]
                e = e.cpu_parent
        if lab is None:
            e, top = ev, ev
            while e is not None:
                top, e = e, e.cpu_parent
            lab, phase = ("optimizer" if "Optimizer" in top.name or "adam" in top.name.lower()
                          else "rest"), "-"
        for name, us in items:
            kind = "convs" if group_of(name) in CONV_GROUPS else "chain"
            key = f"{lab}|{phase}|{kind}"
            out[key] = out.get(key, 0.0) + us / 1e3 / reps
    return out


def profile_multistage(stage_name: str, reps: int) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.models.multi_input_unet import TrainingState
    from unet_bssfp_tpu_torch.train import multistage as ms

    cfg = Config()
    stage = TrainingState(stage_name)
    modality = "dwi-tensor" if stage == TrainingState.PRETRAIN else "pc-bssfp"
    n, p = cfg.data.batch_size, cfg.data.patch_size
    g = torch.Generator().manual_seed(0)
    x = torch.rand((n, p, p, p, 24 if modality == "pc-bssfp" else 6), generator=g).cuda()
    y = torch.rand((n, p, p, p, 6), generator=g).cuda()
    result = {"device": torch.cuda.get_device_name(0), "stage": stage_name,
              "modality": modality, "batch": [n, p, p, p], "reps": reps}
    for act in ("prelu", "leaky_relu"):
        net = ms.build_multi_input_unet(modality, cfg.model, "cuda")
        swapped = leaky_relu_instead(net) if act == "leaky_relu" else 0
        state = ms.create_supervised_state(0, net, cfg.train, stage)
        step = ms.make_supervised_train_step(net, cfg.train)
        annotate_layers(net)
        for _ in range(3):
            step(state, x, y)
        torch.cuda.synchronize()
        clean = []
        for _ in range(reps):
            t0 = time.perf_counter()
            step(state, x, y)
            torch.cuda.synchronize()
            clean.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                step(state, x, y)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        split = layer_split(prof, reps)
        busy = sum(split.values())
        result[act] = {"blocks_swapped": swapped, "unprofiled_ms": statistics.median(clean),
                       "unprofiled_ms_all": clean, "wall_ms": wall_ms, "busy_ms": busy,
                       "split": split}
        del net, state, step, prof
        torch.cuda.empty_cache()

    layers = sorted({k.split("|")[0] for a in ("prelu", "leaky_relu")
                     for k in result[a]["split"]})
    print(f"{result['device']}; multi-stage {stage_name} step ({modality}, bf16, packed, "
          f"{n} × {p}³): PReLU {result['prelu']['unprofiled_ms']:.3f} ms unprofiled, "
          f"LeakyReLU {result['leaky_relu']['unprofiled_ms']:.3f} ms "
          f"({result['leaky_relu']['blocks_swapped']} blocks swapped); device busy "
          f"{result['prelu']['busy_ms']:.3f} / {result['leaky_relu']['busy_ms']:.3f} ms "
          f"a step (median of {reps})")
    print(f"{'layer':28s} {'phase':9s} {'convs':>9s} {'chain':>9s} {'chain LReLU':>12s}")
    for lab in layers:
        for phase in ("forward", "backward", "-"):
            row = [result[a]["split"].get(f"{lab}|{phase}|{kind}", 0.0)
                   for a, kind in (("prelu", "convs"), ("prelu", "chain"),
                                   ("leaky_relu", "chain"))]
            if any(row):
                print(f"{lab:28s} {phase:9s} {row[0]:9.3f} {row[1]:9.3f} {row[2]:12.3f}")
    os.makedirs("perf_out", exist_ok=True)
    out = Path("perf_out") / f"torch_port_profile_multistage_{stage_name}.json"
    out.write_text(json.dumps(result, indent=1))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--whole-volume", action="store_true")
    parser.add_argument("--use-pallas", action="store_true")
    parser.add_argument("--train", action="store_true",
                        help="profile training steps instead of serving")
    parser.add_argument("--mesh", default=None, metavar="DATA,SPACE",
                        help="serve through a mesh over --devices")
    parser.add_argument("--devices", default="cuda:0",
                        help="the mesh's devices, taken in turn (default: every "
                             "position on cuda:0; cuda:0,cuda:1 for two cards)")
    parser.add_argument("--multistage", default=None,
                        choices=("pretrain", "transfer", "finetune"),
                        help="profile one multi-stage step of this stage by layer")
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if args.mesh and (args.train or args.use_pallas):
        parser.error("--mesh profiles serving without --use-pallas")

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_port_profile: no CUDA device", file=sys.stderr)
        return 2
    if args.multistage:
        return profile_multistage(args.multistage, args.reps)
    from unet_bssfp_tpu_torch import weights
    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.eval.inference import predict_volume
    from unet_bssfp_tpu_torch.parallel.mesh import make_mesh
    from unet_bssfp_tpu_torch.train.state import build_models, create_gan_state
    from unet_bssfp_tpu_torch.train.steps import make_predict_fn, make_train_step

    cfg = Config()
    mcfg = dataclasses.replace(cfg.model, use_pallas=args.use_pallas)
    g = torch.Generator().manual_seed(0)
    if args.train:
        state = create_gan_state(0, "pc-bssfp", mcfg, cfg.train, "cuda")
        step = make_train_step(state.gen, state.disc, cfg.train)
        n, p = cfg.data.batch_size, cfg.data.patch_size
        x = torch.rand((n, p, p, p, 24), generator=g).cuda()
        y = torch.rand((n, p, p, p, 6), generator=g).cuda()

        def run():
            step(state, x, y)
    else:
        mesh = None
        if args.mesh:
            mesh = make_mesh(args.devices.split(","), ("data", "space"),
                             tuple(int(p) for p in args.mesh.split(",")))
        gen, _ = build_models("pc-bssfp", mcfg, "cuda")
        sd = weights.random_state_dict(gen, 0)
        gen, _ = build_models("pc-bssfp", mcfg, "cuda:0", state_dict=sd, mesh=mesh)
        fn = make_predict_fn(gen, mesh)
        vol = torch.randn(tuple(cfg.data.volume_shape) + (24,), generator=g).cuda()

        def run():
            predict_volume(fn, vol, patch_size=cfg.data.patch_size,
                           whole_volume=args.whole_volume, mesh=mesh)

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    for _ in range(3):
        run()
    sync()
    clean = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        run()
        sync()
        clean.append((time.perf_counter() - t0) * 1e3)
    clean_ms = statistics.median(clean)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            run()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.reps

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side op events repeat their kernels' time
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            rows.append({"name": ev.key, "group": group_of(ev.key),
                         "calls_per_rep": ev.count / args.reps,
                         "ms_per_rep": dev_us / 1e3 / args.reps})
    rows.sort(key=lambda r: -r["ms_per_rep"])
    busy = sum(r["ms_per_rep"] for r in rows)
    groups = {}
    for r in rows:
        groups[r["group"]] = groups.get(r["group"], 0.0) + r["ms_per_rep"]
    mode = "train" if args.train else ("whole" if args.whole_volume else "patch")
    if args.mesh:
        mode += "_mesh" + args.mesh.replace(",", "x")
        if args.devices != "cuda:0":
            mode += f"_{len(args.devices.split(','))}cards"
    unit = "step" if args.train else "volume"
    launched = sum(r["calls_per_rep"] for r in rows)
    print(f"{torch.cuda.get_device_name(0)}; mode {mode}, use_pallas "
          f"{args.use_pallas}: {clean_ms:.3f} ms/{unit} unprofiled (median of "
          f"{args.reps}); profiled: wall {wall_ms:.3f} ms/{unit}, device busy "
          f"{busy:.3f} ms/{unit} ({100 * busy / wall_ms:.1f} %; summed over the "
          f"cards where the mesh has several), {launched:.0f} kernels launched per {unit}")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"{ms:9.4f} ms  {group}")
    for r in rows[:25]:
        print(f"{r['ms_per_rep']:9.4f} ms  {r['calls_per_rep']:6.1f}x  {r['name'][:110]}")
    os.makedirs("perf_out", exist_ok=True)
    out = Path("perf_out") / f"torch_port_profile_{mode}{'_pallas' if args.use_pallas else ''}.json"
    out.write_text(json.dumps({"device": torch.cuda.get_device_name(0), "mode": mode,
                               "use_pallas": args.use_pallas, "unit": unit,
                               "unprofiled_ms": clean_ms, "unprofiled_ms_all": clean,
                               "wall_ms": wall_ms, "busy_ms": busy,
                               "kernels_launched": launched, "groups": groups,
                               "kernels": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
