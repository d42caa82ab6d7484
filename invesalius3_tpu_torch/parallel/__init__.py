"""Volumes split along Z over a list of devices (port of
invesalius3_tpu/parallel): the shard mesh and placements
(``mesh_utils``), the process-group bootstrap (``distributed``) and the
Z-sharded operations (``sharded_ops``)."""
