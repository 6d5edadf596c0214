"""Data-parallel execution on ``torch.distributed``: the process group and
mesh shape (``mesh``), batch extraction over ranks (``inference``), the SSI
train step (``train``) and train-state checkpoints (``checkpoint``)."""
