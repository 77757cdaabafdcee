"""Post-training int8 quantization for the serving path.

Counterpart of ``mxnet_tpu/quant``:

1. :func:`calibrate`: one forward per calibration batch over the
   eligible FullyConnected/Convolution sites' data inputs, the
   activation amax folded into a device-resident carry and copied to
   the host once at the end; per-output-channel weight ranges from the
   checkpoint, in numpy.
2. :func:`quantize_serving_graph`: rewrite eligible sites onto the two
   serving ops of :mod:`~mxnet_tpu_torch.ops.quant_serve` (static-scale
   int8 quantize -> int8 product with int32 accumulation -> the fused
   dequant epilogue, kernel B6), folding the inference BatchNorm affine
   and a trailing ReLU into the epilogue. Every refused site keeps its
   f32 node and is reported with its reason.
3. :func:`export_quantized`: a ``format_version`` 4 artifact (int8
   weights, about 4x smaller than the f32 ones) that ``load_artifact``
   and the serve engine cache treat as a predict artifact with dtype
   "int8"; ``Server(f32_path, quantized=int8_path)`` serves it beside
   its f32 twin.
"""
from .calibrate import CalibrationResult, SiteInfo, calibrate, find_sites
from .rewrite import quantize_serving_graph

__all__ = ["CalibrationResult", "SiteInfo", "calibrate", "find_sites",
           "quantize_serving_graph", "quantize_serving_model",
           "export_quantized"]


def quantize_serving_model(sym, arg_params, aux_params, calib_batches,
                           data_names=("data",), excluded=(),
                           num_calib_examples=None, device=None):
    """Calibrate (on ``device``, default cuda:0) + rewrite in one call.

    ``calib_batches``: iterable of dict name -> array. Returns
    ``(qsym, qarg_params, qaux_params, report)`` where report is the
    JSON-able ``quant`` record the artifact metadata carries.
    """
    calib = calibrate(sym, arg_params, aux_params, calib_batches,
                      data_names=data_names, excluded=excluded,
                      num_calib_examples=num_calib_examples, device=device)
    return quantize_serving_graph(sym, arg_params, aux_params, calib)


def export_quantized(sym, arg_params, aux_params, calib_batches,
                     data_shapes, path, data_names=None, excluded=(),
                     num_calib_examples=None, dtype="float32",
                     dynamic_batch=False, device=None):
    """Quantize and freeze into a ``format_version`` 4 artifact at
    ``path``; calibration and the export's probe run on ``device``
    (default cuda:0). Returns the artifact metadata (with the ``quant``
    record)."""
    from .. import serving as _serving
    if data_names is None:
        data_names = tuple(data_shapes)
    qsym, qargs, qaux, report = quantize_serving_model(
        sym, arg_params, aux_params, calib_batches,
        data_names=data_names, excluded=excluded,
        num_calib_examples=num_calib_examples, device=device)
    return _serving.export_compiled(
        qsym, qargs, qaux, data_shapes, path, dtype=dtype,
        dynamic_batch=dynamic_batch, device=device, format_version=4,
        extra_meta={"quant": report})
