"""ProPainter's three networks in PyTorch: RAFT optical flow, the recurrent
flow-completion network and the inpainting generator."""
