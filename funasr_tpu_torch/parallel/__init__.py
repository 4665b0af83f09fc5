"""Data-parallel training over ``torch.distributed`` (counterpart of ``funasr_tpu/parallel``):
``sharding.py`` (the process group, the FSDP2 policy, the global batch's rows, the loss
normalizers summed over the group) and ``dryrun.py`` (one step of a tiny Paraformer under
dp and fsdp in n gloo processes on the CPU)."""
