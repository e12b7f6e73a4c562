"""The example drivers — counterparts of the reference's ``examples/``, run
as ``python -m cpprob_tpu_torch.examples.<name>``.  Each exposes
``main(argv=None)``, does its work only there, and takes ``--device``
(default ``cuda``: with no card it raises unless given ``--device cpu``).

Not twinned: ``external_tpu.py`` (staging for a runtime without host
callbacks; the card calls the host directly), ``comms_model.py`` (an
analytic interconnect model of the TPU), ``run_tpu_tests.py`` (the TPU
test runner), ``roofline.py`` (ported as ``ops/calibrate.py`` and
``util/roofline.py``) and ``guided_microbench.py`` (covered by
``util/guided_*_parts.py``)."""
