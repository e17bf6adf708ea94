"""The program's analyses as a cell drives them, one module an
analysis, found by a configuration's ``"analysis"`` key.  Each module
provides ``run(u, cfg, device, stop=None, **kwargs)`` (one whole
analysis through the program, with the source's ``analysis_kwargs``
passed on to the program's ``run``, ended by a device synchronise → its
answer as host arrays and its ``results.observability``; an analysis
that no source gives keywords may leave out ``**kwargs``),
``reference(cfg, frames,
precision)`` (the plain reference's answer), ``compare(answers, ref)``
and ``least_time_s(cfg, n_frames, answer, bw, flops)`` (the device
work's least time, :mod:`portbench.roofline`)."""


def to_host(x):
    """A result (tensor, array or deferred value) as a numpy array."""
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
