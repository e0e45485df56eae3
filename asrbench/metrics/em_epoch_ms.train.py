"""Mean host ms of ``Trainer.scheme2_epoch`` over the corpus (it ends in
its own ``float(loglik)``, which waits for the device)."""


def read(run):
    s = run.spans.get("em_epoch")
    return 1e3 * sum(s) / len(s) if s else None
