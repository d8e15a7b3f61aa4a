"""A test-only fit family: LMF's epochs, recorded through the
configuration's ``state_hook`` (``models/lmf.py:_lmf_class_update``, one
bucket class of one side a call, in place on its first argument; the user
side's classes first, ``pin_col`` -2, then the item side's, -1), and judged
against the fitted model: one record an epoch, the tables after its item
side, the last the model's final tables."""

import numpy as np


class Recorder:
    def __init__(self, params):
        self.records, self.last_side = [], None

    def wrap(self, fn, name):
        def recorded(T, dss, other, *args, **kwargs):
            out = fn(T, dss, other, *args, **kwargs)
            side = "item" if kwargs["pin_col"] == -1 else "user"
            if side == "item":
                state = (other.detach().clone(), T.detach().clone())
                if self.last_side == "item":  # a later class of the same epoch
                    self.records[-1] = state
                else:
                    self.records.append(state)
            self.last_side = side
            return out
        return recorded

    def answers(self, model, random_state):
        return dict(records=self.records, final=(model.user_factors, model.item_factors))


def fit_recorder(params):
    return Recorder(params)


def fit_answers(user_items, params, random_state, device, precision):
    raise NotImplementedError("the probe has no reference fit")


def judge_fit_answers(user_items, params, random_state, answers, device):
    records, final = answers["records"], answers["final"]
    gap = (max(float(np.abs(r.cpu().numpy() - f).max()) for r, f in zip(records[-1], final))
           if records else float("inf"))
    return dict(epochs_missing=abs(len(records) - int(params["iterations"])), final_gap=gap)
