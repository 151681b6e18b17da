"""Seconds of the program's load of the training split (``NeRFDataset``), in set-up."""


def read(r):
    return r.spans.get("data_load_s")
