"""The traffic: the same for one seed, another for another, with the same
set of lengths for every seed."""

import numpy as np
import torch

from asrbench.harness import spec
from asrbench.harness.model import build_model, make_bank
from asrbench.harness.runner import _merge
from asrbench.harness.traffic import lengths_s, make_batches
from conftest import SMALL


def _traffic(cell, seed):
    w = spec.workload(cell)
    cfg = _merge(spec.config(w["config"]), SMALL[cell]["config"])
    mix = _merge(spec.traffic(w["traffic"]), SMALL[cell]["traffic"])
    model = build_model(cfg, seed)
    return model, make_batches(model, make_bank(model, seed, "cpu"), mix,
                               seed)


def test_same_seed_same_traffic_other_seed_other_traffic():
    for cell in SMALL:
        _, a = _traffic(cell, 2**31 + 7)
        _, b = _traffic(cell, 2**31 + 7)
        _, c = _traffic(cell, 2**31 + 8)
        for x, y in zip(a, b):
            assert torch.equal(x.feats, y.feats)
            assert np.array_equal(x.labels, y.labels) and x.words == y.words
        assert not torch.equal(a[0].feats, c[0].feats)
        # the seed changes the order and the content, not the work
        assert sorted(a[0].n_frames) == sorted(c[0].n_frames)
        assert [sorted(x.n_frames) for x in a] == [sorted(x.n_frames)
                                                    for x in c]


def test_lengths_follow_the_mix():
    mix = spec.traffic("offline_read_b128")
    s = lengths_s(mix["seconds"], mix["batch"])
    assert len(s) == 128 and 1.5 <= s.min() and s.max() <= 12.0
    assert abs(np.median(s) - 4.2) < 0.05
    s = lengths_s(spec.traffic("train_long_b256")["seconds"], 256)
    assert abs(s.mean() - 9.0) < 1e-9 and s.min() > 6 and s.max() < 12


def test_labels_fit_the_training_budget_at_full_size():
    """At the cell's own lengths every label fits ``max_label_len``."""
    cfg = spec.config("cd_tied2k_m16")
    mix = spec.traffic("train_long_b256")
    longest = mix["seconds"]["hi"] * mix["syllables_per_s"]
    units = 2 * 2 * int(np.ceil(np.ceil(longest) / 2)) + 2
    assert units <= cfg["train"]["max_label_len"]


