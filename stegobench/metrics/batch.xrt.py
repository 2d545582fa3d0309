"""batch.xrt: the batched decode's audio seconds a second over a traced
run's whole window, as ``xrt`` takes them (the audio of the window's
requests over the window, less the harness's bookkeeping), the profiled
stretch inside it. ``clip128.batch_decode``'s walls move in the host's
slow phases by more than any bound allows, so there it is read here,
unbounded, and the card's kernel time is its end-to-end metric. Moves
``kernel_ms_per_audio_s``."""

UNIT = "audio_s/s"
MOVES = "kernel_ms_per_audio_s"


def read(run):
    if run.run_window_s <= 0 or run.run_audio_s <= 0:
        return None
    return run.run_audio_s / run.run_window_s
