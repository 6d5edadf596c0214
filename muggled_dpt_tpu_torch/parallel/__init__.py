"""Data and tensor parallelism on ``torch.distributed``: the process groups
and the (data, model) mesh (``mesh``), the Megatron split of the blocks over
the model axis (``tensor``), batch extraction over ranks (``inference``),
the SSI train step (``train``) and train-state checkpoints (``checkpoint``)."""
