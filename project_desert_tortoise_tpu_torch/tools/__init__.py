"""Measurement tools of the port: the ablation kernels that attribute a
per-lane serial chain's time on the card (``ablate_kernel``,
``ablate_fused``), and the study of decode success against upsample level
(``study_upsampling``)."""
