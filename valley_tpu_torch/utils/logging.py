"""The port's own copy of the part of ``valley_tpu/utils/logging.py`` its
serve modules use: `server_error_msg`, the text a stream carries when a
request fails.
"""

server_error_msg = ("**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE REGENERATE "
                    "OR REFRESH THIS PAGE.**")
