"""The yardstick's peaks: NVIDIA's H100 SXM data sheet, dense rates at the
700 W limit (989 TFLOP/s bf16, 3.35 TB/s HBM).  The operations and bytes
of the work a cell ran are its architecture's to count
(``reference/<module>.py``: ``prefill_ops``, ``decode_ops``,
``attention_bound_s``, ``train_step_ops``).
"""

PEAK_FLOPS = 989e12          # bf16 dense
HBM_BW = 3.35e12             # bytes/s
BF16_BYTES = 2
