"""Scale-out over a device mesh, port of textslam_tpu/parallel/:
observation- and landmark-sharded bundle adjustment (ba_sharded), the
keyframe-axis-sharded covisibility product (covis_sharded) and batched ORB
extraction (features), all over the Mesh of parallel.mesh."""
