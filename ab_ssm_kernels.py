#!/usr/bin/env python3
"""Device time of the SSM kernels of one checkout, for comparing two
checkouts on one card.

    python3 ab_ssm_kernels.py PARENT && python3 ab_ssm_kernels.py . \
        && python3 ab_ssm_kernels.py . && python3 ab_ssm_kernels.py PARENT

Each run imports ``repro_torch`` and ``chip_smoke.py`` from the checkout
given (its kernels built into that checkout's ``build/``) and times, with
``chip_smoke``'s CUDA-event timer (the L2 flushed before every call,
median of 30), three times each: the SSD at zamba2-2.7b's training shape
(2 x 1024), on a 128-chunk chain (1 x 8192, one head) and at serving's
fixed batch (4 x 64), and the scan at falcon-mamba-7b's training shape
and serving's fixed batch, all bf16 without the final state.  Prints one
line ``AB {json}``.  Run the checkouts in turns, as above, in one call on
one card.
"""

import json
import sys


def main(tree: str) -> int:
    sys.path.insert(0, f"{tree}/src")
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.mamba_scan.kernel import selective_scan_cuda
    from repro_torch.kernels.ssd.kernel import ssd_cuda

    if not torch.cuda.is_available():
        print("ab_ssm_kernels: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    bf = torch.bfloat16
    out = {"tree": tree, "device": torch.cuda.get_device_name(0)}
    for name, shape, chunk in (("ssd_train", (2, 1024, 80, 64, 1, 64), 256),
                               ("ssd_chain128", (1, 8192, 1, 64, 1, 64), 64),
                               ("ssd_serve", (4, 64, 80, 64, 1, 64), 256)):
        a = cs.ssd_inputs(torch, gen, *shape, 0.1, bf, dev)
        out[name] = [cs._time_ms(torch, lambda: ssd_cuda(*a, chunk=chunk),
                                 l2.zero_) * 1e3 for _ in range(3)]
    for name, shape in (("scan_train", (2, 1024, 8192, 16)),
                        ("scan_serve", (4, 64, 8192, 16))):
        a = cs.scan_inputs(torch, gen, *shape, 0.1, bf, dev)
        out[name] = [cs._time_ms(torch, lambda: selective_scan_cuda(
            *a, chunk=256, c_block=64), l2.zero_) * 1e3 for _ in range(3)]
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "."))
