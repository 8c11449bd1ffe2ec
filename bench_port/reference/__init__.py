"""The plain reference the benchmark holds the program to: the GraspBalance
eval forward with each configuration's backbone (``backbones/``), its
decode, the DSN, mean shift, OBS, grasp NMS, the voxel downsample and the
collision filter, in plain PyTorch and float32 (TF32 off). It imports
nothing of the program: the benchmark hands it the same inputs and
weights."""
