"""ProPainter's three networks in PyTorch: RAFT optical flow, the recurrent
flow-completion network and the inpainting generator."""

from vsr_tpu_torch.models.propainter.raft import RAFT, raft_bi_flows
from vsr_tpu_torch.models.propainter.flow_completion import RecurrentFlowCompleteNet

__all__ = ["RAFT", "raft_bi_flows", "RecurrentFlowCompleteNet"]
