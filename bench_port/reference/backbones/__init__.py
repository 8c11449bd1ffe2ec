"""The reference backbones, one file each, ``<name>.py``, found by the
configuration's ``model.backbone`` name (``reference/models.py:backbone_file``).
Each is plain PyTorch in float32 (TF32 off) and imports nothing of the
program. A file defines:

  Backbone(stages, num_seed)  the module, its state-dict names the program's
                   backbone's, so that one draw of weights fills both;
                   ``forward(xyz, sampled)`` returns the end points the
                   heads read: ``input_xyz``, ``fp2_xyz``, ``fp2_features``,
                   ``fp2_inds`` and the sampled indices
  Backbone.SAMPLED  its sampling contract: the end-point keys of the indices
                   it takes from the raw cloud. The serving check compares
                   exactly these with the reference's (``fps_mismatch``) and
                   hands the program's to the reference's forward
  Backbone.sample(xyz)  {key: indices} of ``SAMPLED``, computed from the raw
                   cloud
  Backbone.fps_prefix  where the contract is one FPS of the raw cloud whose
                   first ``fps_prefix`` indices are its one sampled key, that
                   length, and None otherwise. The OBS path shares that FPS
                   with the DSN, and refuses a backbone without one
  TINY_STAGES      its stage table for the CPU tests

Its operation count is ``counts/backbones/<name>.py``.
"""
