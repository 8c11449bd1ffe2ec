"""Serving: grasp NMS, voxel downsampling and the collision filter,
mean-shift clustering, object-balanced sampling (OBS) and the end-to-end
``GraspInference`` pipeline (``eval/pipeline.py``, with ``dump_dataset``),
and the closed-loop quality of the grasp model (``quality.py``) and of the
DSN (``seg_quality.py``)."""
