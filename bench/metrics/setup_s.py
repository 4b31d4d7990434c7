"""setup_s: from the start of the process to the first timed round:
imports, the weights drawn on the card, the trainer, and rounds 1 and 2
(judged after the window; round 1 runs the update eagerly, then
captures its graph) (host clock)."""


def read(ctx):
    return ctx.setup_s
