"""A test-only fit family: BPR's grouped epoch, recorded through the
configuration's ``state_hook`` (``models/bpr.py:_bpr_epoch_grouped``, one
epoch a call, in place on its first three arguments: the user table, the
item table and the item biases), and judged against the fitted model: one
record an epoch, the last the model's final tables."""

import numpy as np


class Recorder:
    def __init__(self, params):
        self.records = []

    def wrap(self, fn, name):
        def recorded(X, Y, yb, *args, **kwargs):
            out = fn(X, Y, yb, *args, **kwargs)
            self.records.append(tuple(t.detach().clone() for t in (X, Y, yb)))
            return out
        return recorded

    def answers(self, model, random_state):
        F = model.factors
        return dict(records=self.records,
                    final=(model.user_factors[:, :F], model.item_factors[:, :F],
                           model.item_factors[:, F]))


def fit_recorder(params):
    return Recorder(params)


def fit_answers(user_items, params, random_state, device, precision):
    raise NotImplementedError("the probe has no reference fit")


def judge_fit_answers(user_items, params, random_state, answers, device):
    records, final = answers["records"], answers["final"]
    gap = (max(float(np.abs(r.cpu().numpy() - f).max()) for r, f in zip(records[-1], final))
           if records else float("inf"))
    return dict(epochs_missing=abs(len(records) - int(params["iterations"])), final_gap=gap)
