"""Mean host ms of the alignment pass: ``align_batch`` over every batch
with the new bank, ending in the alignments' copy to the host."""


def read(run):
    s = run.spans.get("align_pass")
    return 1e3 * sum(s) / len(s) if s else None
