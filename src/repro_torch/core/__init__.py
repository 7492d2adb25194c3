"""Strategy execution of the port: the precision policies and the
data-parallel plan (``parallel``), the analytic cost model
(``costmodel``) and the pipeline-schedule grammar (``pipeline``)."""
