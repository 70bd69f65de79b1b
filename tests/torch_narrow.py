"""A narrow STTN for the port's tests that drive sttn-auto in a process of
their own (not a test file): tests/test_torch_tasks.py's spawned TaskRunner
worker and tests/test_torch_bench.py's bench_parity_torch.py subprocess."""

from vsr_tpu_torch import tasks

_WORKER = tasks._worker


def narrow_sttn():
    """Has sttn-auto build its STTN, in this process, at the narrow width of
    tests/test_torch_sttn_auto.py's CLI test (channel 16, one block): the
    same code as the full-width default, in seconds on the CPU."""
    from vsr_tpu_torch.inpaint import sttn_auto
    from vsr_tpu_torch.models.sttn import STTNGenerator

    sttn_auto.STTNGenerator = lambda *, variant, use_kernel: STTNGenerator(
        variant=variant, use_kernel=use_kernel, channel=16, stack_num=1)


def narrow_sttn_worker(*args):
    """tasks._worker with narrow_sttn() in the spawned process (module
    level, so that process can import it)."""
    narrow_sttn()
    _WORKER(*args)
