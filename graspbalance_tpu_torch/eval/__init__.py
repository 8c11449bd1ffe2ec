"""Serving: grasp NMS, voxel downsampling and the collision filter,
mean-shift clustering, object-balanced sampling (OBS) and the end-to-end
``GraspInference`` pipeline (``eval/pipeline.py``)."""
