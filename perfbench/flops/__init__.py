"""Operation and byte counts from shapes, one file per kernel or model
part. Each input byte is counted read once and each output byte written
once; operations are those the algorithm needs for the inputs given."""
