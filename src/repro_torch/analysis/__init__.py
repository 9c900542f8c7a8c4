"""The analysis plane of the port: the H100 roofline (``roofline``), the
counter of a step's work (``counter``), the analytic memory of a rank
(``memory_est``) and the dry-run tables (``report``, ``reanalyze``)."""
