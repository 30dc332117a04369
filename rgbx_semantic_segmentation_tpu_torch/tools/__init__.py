"""The port's tools: the offline dataset scripts (resize_images,
check_labels, compare_labels, copy_split, clean_logs, split_rgbt,
visualize_labels, fetch_mfnet), the input-pipeline benchmark (bench_input),
the card check (check_gpu) and the kernel benches (bench_*_attention, which
need the card)."""
