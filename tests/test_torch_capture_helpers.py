"""A CPU stand-in for the capture context of ``councilx_torch/utils/
graphs.py``, for the tests of the captured routes' protocol
(tests/test_torch_graphs.py, tests/torch_dist_worker.py and the tests that
drive it); this file holds no tests and imports no JAX.

A card captures a function once and replays the graph on new values of its
static inputs; the stand-in keeps static copies of the inputs and re-runs
the function on them at every replay, so a route over it makes the same
warm-up calls, static buffers, keys and copies as on the card.
:func:`use_stand_in` patches it into the modules that capture.
"""

import torch


class _Replayed:
    """A captured call's stand-in: static inputs, and each replay runs the
    function on them again (a card replays the captured graph)."""

    def __init__(self, fn, inputs, name):
        self.fn, self.name = fn, name
        self.inputs = [t.clone() for t in inputs]
        self.capture_seconds = 0.0
        self.replays = 0

    def copy_inputs(self, inputs):
        for dst, src in zip(self.inputs, inputs):
            assert dst.shape == src.shape and dst.dtype == src.dtype
            dst.copy_(src)

    def replay(self):
        self.replays += 1
        return self.fn(*self.inputs)

    def __call__(self, *inputs):
        self.copy_inputs(inputs)
        return self.replay()


class _CpuContext:
    def __init__(self, device, what=""):
        self.device = torch.device(device)
        self.runs = 0

    def run(self, fn, *args):
        self.runs += 1
        return fn(*args)

    def capture(self, fn, inputs, name):
        return _Replayed(fn, inputs, name)


def use_stand_in(setattr_) -> None:
    """Capture on the CPU over the stand-in: ``setattr_(obj, name, value)``
    (``monkeypatch.setattr``, or ``setattr`` in a worker process) swaps it
    in for the capture context of the trainer and the translators, and
    makes the CPU count as capturable, so ``compile_step`` and the train
    loop take the captured route there."""
    from councilx_torch.inference import translate
    from councilx_torch.train import trainer
    from councilx_torch.utils import graphs

    setattr_(trainer, "CaptureContext", _CpuContext)
    setattr_(translate, "CaptureContext", _CpuContext)
    setattr_(graphs, "capturable", lambda device: True)
