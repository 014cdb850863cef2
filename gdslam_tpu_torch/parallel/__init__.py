"""Many sequences tracked at once on one card (port of gdslam_tpu.parallel)."""
