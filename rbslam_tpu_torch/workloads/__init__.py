"""Runnable workloads (port of rbslam_tpu/workloads/)."""
