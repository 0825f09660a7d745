"""Command-line tools of the port: microbenchmarks (bench, bench_gather,
bench_table_grad), the render tool, and the dataset tools that prepare and
inspect a sequence without OpenCV or h5py (undistort_images, numpys_to_h5,
inspect_h5, psnrs_corr, raw_to_png)."""
