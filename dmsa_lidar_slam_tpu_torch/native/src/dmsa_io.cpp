// Native IO fast path for dmsa_lidar_slam_tpu_torch (a copy of
// dmsa_lidar_slam_tpu/native/src/dmsa_io.cpp; only these header lines differ).
//
// Vectorized extraction of per-vendor PointCloud2 fields (the hot inner
// loop of scan ingestion; equivalent of the per-point memcpy loops in the
// reference's src/dmsa_slam_ros.cpp:399-486) and rosbag1 record scanning
// helpers.  Exposed through a plain C ABI for ctypes.
//
// Built at first use by io/native.py: g++ -> build/native/libdmsa_io_<hash>.so

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// Sensor type codes (must match io/native.py)
enum SensorType : int32_t {
  SENSOR_HESAI = 0,
  SENSOR_OUSTER = 1,
  SENSOR_ROBOSENSE = 2,
  SENSOR_VELODYNE = 3,
  SENSOR_LIVOX_S = 4,
  SENSOR_LIVOX_NS = 5,
  SENSOR_SICK = 6,
  SENSOR_UNKNOWN = 7,
};

// Decode one PointCloud2 payload into SoA arrays.
//   data        raw point buffer (n * point_step bytes)
//   n           number of points
//   point_step  bytes per point
//   off_*       byte offsets of the x/y/z + stamp + ring fields
//               (pass -1 for unused)
//   msg_stamp   message header stamp in seconds
//   delta_t     inter-message time (sensor "unknown" stamp synthesis)
// Outputs: xyz [n*3] float, stamps [n] double, rings [n] int32.
// Returns 0 on success.
int decode_pointcloud2(const uint8_t* data, int64_t n, int32_t point_step,
                       int32_t off_x, int32_t off_y, int32_t off_z,
                       int32_t off_stamp, int32_t off_ring,
                       int32_t sensor, double msg_stamp, double delta_t,
                       float* xyz, double* stamps, int32_t* rings) {
  for (int64_t k = 0; k < n; ++k) {
    const uint8_t* p = data + k * point_step;
    float x, y, z;
    std::memcpy(&x, p + off_x, 4);
    std::memcpy(&y, p + off_y, 4);
    std::memcpy(&z, p + off_z, 4);
    xyz[3 * k + 0] = x;
    xyz[3 * k + 1] = y;
    xyz[3 * k + 2] = z;

    switch (sensor) {
      case SENSOR_HESAI: {
        double s;
        uint16_t r;
        std::memcpy(&s, p + off_stamp, 8);
        std::memcpy(&r, p + off_ring, 2);
        stamps[k] = s;
        rings[k] = r;
        break;
      }
      case SENSOR_OUSTER: {
        uint32_t rel_ns;
        uint8_t r;
        std::memcpy(&rel_ns, p + off_stamp, 4);
        std::memcpy(&r, p + off_ring, 1);
        stamps[k] = msg_stamp + 1e-9 * static_cast<double>(rel_ns);
        rings[k] = r;
        break;
      }
      case SENSOR_ROBOSENSE: {
        double s;
        uint16_t r;
        std::memcpy(&s, p + off_stamp, 8);
        std::memcpy(&r, p + off_ring, 2);
        stamps[k] = s;
        rings[k] = r;
        break;
      }
      case SENSOR_VELODYNE: {
        float rel_s;
        uint16_t r;
        std::memcpy(&rel_s, p + off_stamp, 4);
        std::memcpy(&r, p + off_ring, 2);
        stamps[k] = msg_stamp + static_cast<double>(rel_s);
        rings[k] = r;
        break;
      }
      case SENSOR_LIVOX_S: {
        double s;
        std::memcpy(&s, p + off_stamp, 8);
        stamps[k] = s;
        rings[k] = static_cast<int32_t>(k % 1000);
        break;
      }
      case SENSOR_LIVOX_NS: {
        double s;
        std::memcpy(&s, p + off_stamp, 8);
        stamps[k] = 1e-9 * s;  // livox2 driver ns bug workaround
        rings[k] = static_cast<int32_t>(k % 1000);
        break;
      }
      case SENSOR_SICK: {
        float rel_s;
        int8_t r;
        std::memcpy(&rel_s, p + off_stamp, 4);
        std::memcpy(&r, p + off_ring, 1);
        stamps[k] = msg_stamp + static_cast<double>(rel_s);
        rings[k] = r;
        break;
      }
      case SENSOR_UNKNOWN: {
        stamps[k] = msg_stamp + delta_t * static_cast<double>(k) /
                                    static_cast<double>(n > 0 ? n : 1);
        rings[k] = static_cast<int32_t>(k % 1000);
        break;
      }
      default:
        return -1;
    }
  }
  return 0;
}

// Range filter + finite check: writes keep mask (0/1) for points with
// min_dist < |p| < max_dist and finite coordinates.  Returns kept count.
int64_t range_mask(const float* xyz, int64_t n, float min_dist,
                   float max_dist, uint8_t* keep) {
  int64_t count = 0;
  for (int64_t k = 0; k < n; ++k) {
    const float x = xyz[3 * k], y = xyz[3 * k + 1], z = xyz[3 * k + 2];
    const float r2 = x * x + y * y + z * z;
    const bool finite = std::isfinite(x) && std::isfinite(y) && std::isfinite(z);
    const bool ok = finite && r2 > min_dist * min_dist && r2 < max_dist * max_dist;
    keep[k] = ok ? 1 : 0;
    count += ok ? 1 : 0;
  }
  return count;
}

}  // extern "C"
