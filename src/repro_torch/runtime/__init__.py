# Runtime pieces of the port, host-side around the engine:
#
#   sog_compress.py — self-organizing checkpoint compression: sort the
#                     columns of each weight with ShuffleSoftSort, then
#                     int8-quantize, delta-code and deflate them
