"""The four demos of ``examples/`` on the port; each runs as
``python -m dicp_tpu_torch.examples.<name>`` on the card (``main(device)``
takes another device) and raises if its check fails:

* :mod:`large_cloud_demo`: 100k-point registration with self-computed
  normals and the exactness certificate of the final correspondences;
* :mod:`odometry_demo`: disk -> ScanDataset -> batched pt2pl odometry with
  a loop closure -> ATE;
* :mod:`serving_demo`: the streaming pipeline, f32 and quantized transfers;
* :mod:`slam_demo`: closed-loop SLAM on a multi-lap circuit
  (``SLAM_DEMO_LAPS``).
"""
