"""The whole fit's share of the card's peak: the operations of the
reference algorithm's iterations (``lib/counts.py``, from rows, nnz and F)
over the mean fit wall of the traced window times the peak of the tables'
type, in %."""


def read(run):
    rec = run.record
    if rec["kind"] != "fit" or run.peaks is None or not rec["walls"]:
        return None
    ops = run.shape["iterations"] * run.counts.als_iteration_ops(run.shape)
    wall = sum(rec["walls"]) / len(rec["walls"])
    return 100.0 * ops / (wall * run.peaks["flops"][run.shape["dtype"]])
