"""Valid samples of the train march (device counter ``train.valid_samples``, the march
mask's sum a step) per ray of the steps (counter ``train.ray_count``)."""

from portbench.program_spans import ratio


def read(r):
    return ratio(r, "train.valid_samples", "train.ray_count")
