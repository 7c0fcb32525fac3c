"""The CNN train step with cuDNN's algorithm search (``cudnn.benchmark``)
off or on, in a fresh process per setting, on a CUDA card:

    python -m learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.cudnn_search 0
    python -m learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.cudnn_search 1

Prints the first train-mode fwd+bwd of full-width ``enhanced_cnn`` at
batch 64 (cuDNN's first use, and the search when on), the mean step time
of three rounds of 40 train steps, and the profiled device busy time of
8 train steps + 1 validation step.  Run the settings alternately, each in
its own process: the search's choices live for the process.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import config, driver, train
from .data import load_dataset

STEPS = 40


def main(argv: list[str]) -> int:
    search = argv == ["1"]
    if argv not in (["0"], ["1"]):
        raise SystemExit("usage: cudnn_search 0|1")
    cfg = config.config_from_args(["--epochs_local", "1"])
    dev = driver.resolve_device(cfg.device)
    torch.backends.cudnn.benchmark = search
    data, _ = load_dataset("cifar10", seed=0, limit_train=64 * STEPS,
                           limit_test=1)
    x = data.images.reshape(1, STEPS, 64, 32, 32, 3)
    y = data.labels.reshape(1, STEPS, 64)
    pack = (x, y, np.ones((1, STEPS, 64), np.float32))
    val = tuple(a[:, :1] for a in pack)
    model = driver.build_model_for(cfg, 10, dev)
    engine = train.LocalSGDEngine(model, cfg, dev)
    state = engine.init_state()
    t0 = time.perf_counter()
    model.train()
    model(train.to_device(x[0, 0], dev)).float().sum().backward()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    steady = []
    for _ in range(3):
        state, mx = engine.round(state, pack, val)
        steady.append(mx["train_ms"] / STEPS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.round(state, tuple(a[:, :8] for a in pack), val)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"benchmark={int(search)}: first train fwd+bwd {first:.3f} s; "
          f"steady {' / '.join(f'{s:.3f}' for s in steady)} ms/step; device "
          f"busy {busy:.3f} ms per 8 train + 1 val step "
          f"({busy / 8:.3f} ms/step); {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
