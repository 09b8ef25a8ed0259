"""The parallel layer: device meshes driven from one process, frame- and
element-sharded encode, decode and campaigns, and multi-process campaigns
over ``torch.distributed`` (the port of ``polar_tpu.parallel``)."""
