"""Percent of its roofline that the ``selective_scan`` kernel reached:
the least time of the scans that the sub-window's prefills needed (one
a layer, at each prompt's length, ``roofline/selective_scan.py``) over
the device time of ``selective_scan_kernel``."""

KERNEL = "selective_scan"
NAMES = ("selective_scan_kernel",)


def read(run):
    s = run.sizes
    channels = int(s["ssm_expand"]) * int(s["d_model"])
    calls = [(n, channels, int(s["ssm_state"]))
             for n in run.prefills() for _ in range(int(s["num_layers"]))]
    return run.roofline(KERNEL, calls, *NAMES)
