"""nuScenes lidarseg: label taxonomy and the devkit-free readers (copies
of `taseg_tpu/data/nuscenes/`)."""
