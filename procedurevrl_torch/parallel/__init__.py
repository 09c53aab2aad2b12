"""Data parallel over processes: the collectives and the DDP / ZeRO-1
wrappers (counterpart of ``procedurevrl_tpu/parallel``)."""
