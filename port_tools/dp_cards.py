"""Data parallelism across cards on NCCL: one rank per card
(ubteacher_tpu_torch.parallel.launch), against one process on one card.

1. The small FCOS case of chip_smoke.py's phase 13 (a) (4 + 4 images at
   64x96, float32, injected draws for the global batch; a burn-in and a
   mutual step from the same weights) on N ranks, one row of each stream a
   rank at N = 4, held as phase 13 holds it: counts equal, losses as
   agree() holds them, updates within 1e-2 of one process's, the ranks'
   parameters bitwise equal.
2. Weak scaling at full width: phase 4's (6's) FCOS (R-CNN) slice steps,
   8 + 8 images a rank at 768x1344, so N ranks take a global batch of
   8N + 8N: burn-in, boundary and MUTUAL timed mutual steps, each ending in
   a synchronize, on every rank; then the gradients' all-reduce alone
   (parallel.reduce_gradients, CUDA events over 20 calls). One process on
   card 0 runs the same steps without a process group before and after the
   ranks.

    python3 port_tools/dp_cards.py [--cards N]   # from the repo root, on N cards

Prints the comparisons and one JSON line of the medians.
"""
import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ubteacher_tpu_torch.parallel import launch, local_rank, rank, reduce_gradients, world_size  # noqa: E402
from ubteacher_tpu_torch.tools import common  # noqa: E402

MUTUAL = 5
OUT = os.path.join(cs.ROOT, "ubteacher_tpu_torch", "_build", "dp_cards")


def time_steps(rcnn, device):
    """Burn-in, boundary and MUTUAL mutual steps of a slice at 8 + 8 images
    on this process -> (ms per step, the gradients' all-reduce ms or None)."""
    _, (burnin, mutual), state, batch = common.step_setup(rcnn, device)
    ms = []
    for _ in range(2 + MUTUAL):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = (burnin if state.step < 1 else mutual)(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    allreduce = None
    if world_size() > 1:
        params = list(state.student.parameters())
        reduce_gradients(params)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            reduce_gradients(params)
        end.record()
        torch.cuda.synchronize()
        allreduce = start.elapsed_time(end) / 20
    del state, batch
    torch.cuda.empty_cache()
    return ms, allreduce


def rank_main():
    device = torch.device("cuda", local_rank())
    out = {"small": cs.run_dp_small(device, names=("fcos",)), "card": torch.cuda.get_device_name(device)}
    for name, rcnn in (("fcos", False), ("rcnn", True)):
        out[name] = time_steps(rcnn, device)
    torch.save(out, os.path.join(OUT, f"rank{rank()}.pt"))


def one_card(device):
    return {name: time_steps(rcnn, device)[0] for name, rcnn in (("fcos", False), ("rcnn", True))}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cards", type=int, default=torch.cuda.device_count())
    cards = parser.parse_args().cards
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        raise SystemExit(f"dp_cards: {cards} cards asked, {torch.cuda.device_count()} visible")
    common.triton_cache_in_checkout()
    os.makedirs(OUT, exist_ok=True)
    device = torch.device("cuda", 0)
    power = cs.gpu_name_and_power()
    cs.log(f"{cards} cards; first: {power}")
    cs.build_kernels()
    ref = cs.run_dp_small(device, names=("fcos",))
    before = one_card(device)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launch(rank_main, cards, backend="nccl")
    cs.log(f"{cards} nccl ranks: {time.perf_counter() - t0:.1f} s with spawn")
    after = one_card(device)
    ranks = [torch.load(os.path.join(OUT, f"rank{r}.pt"), weights_only=False) for r in range(cards)]
    cs.check_dp_small(f"{cards} nccl ranks", ref, [rk["small"] for rk in ranks])
    summary = {"cards": cards, "card": power}
    for name in ("fcos", "rcnn"):
        one = [statistics.median(run[name][2:]) for run in (before, after)]
        per_rank = [statistics.median(rk[name][0][2:]) for rk in ranks]
        allreduce = [rk[name][1] for rk in ranks]
        cs.log(f"{name}: one card, 8 + 8 a step: mutual ms {[round(x, 1) for x in before[name]]} before, "
               f"{[round(x, 1) for x in after[name]]} after the ranks")
        for r, rk in enumerate(ranks):
            cs.log(f"{name} rank {r} ({rk['card']}), 8 + 8 of a global {8 * cards} + {8 * cards}: steps "
                   f"{[round(x, 1) for x in rk[name][0]]} ms; gradient all-reduce {rk[name][1]:.3f} ms")
        step = max(per_rank)
        summary[name] = {"one_card_mutual_ms": one, "rank_mutual_ms": per_rank, "allreduce_ms": allreduce,
                         "img_per_s_one_card": 16e3 / statistics.mean(one),
                         "img_per_s_all_cards": 16e3 * cards / step,
                         "scaling_efficiency": statistics.mean(one) / step}
    cs.log(power)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
