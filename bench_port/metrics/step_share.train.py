"""Share of the training window the host spends inside the program's step
calls (`GraphTrainStep.run` for a K-step chunk, `__call__` for a remainder
step): the harness's `step` spans over the window, in %."""


def read(ctx):
    spans = ctx.spans.get("step")
    if not spans:
        return None
    return 100.0 * sum(spans) / ctx.window_s
