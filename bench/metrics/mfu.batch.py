"""Percent of the chip's bf16 peak that the whole serving step reached:
the model FLOPs of the prompts prefilled and the rows decoded for live
requests in the traced sub-window (``roofline/model_<family>.py``) over
the sub-window's length."""


def read(run):
    return run.mfu()
