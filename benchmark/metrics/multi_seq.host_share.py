"""multi_seq.host_share: the share of the window's host time in which no
joint chunk ran on the card: (window − Σ ``chunk_fn`` spans) / window,
each span ended by a synchronize, the traced slice left out."""


def read(run):
    if run.system != "multi_seq" or run.window_s <= 0 or run.chunk_fn_s <= 0:
        return None
    return (run.window_s - run.chunk_fn_s) / run.window_s
