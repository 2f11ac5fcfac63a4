"""``mfu.train``'s reading in the grid-cache cell, which reports its own
rate (``train_samples_per_s.grid_cache``): the same reader."""

from perfbench.spec import load_metric

read = load_metric("mfu.train").read
