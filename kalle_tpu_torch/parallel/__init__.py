"""Parallelism over torch.distributed: the dp/tp/sp/pp mesh and parameter
layouts (`mesh`), differentiable collectives (`collectives`), process
set-up (`multihost`), GPipe and 1F1B pipelines, and a multi-process CPU
dryrun (`dryrun`)."""
